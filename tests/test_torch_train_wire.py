"""Two trajectories of the port's trainer on the emulated wires: lgc_rar
on ring_packed against the mesh run bit for bit, and ring_hier on a
(2, 2) pod mesh against the reference's own training step on 4 host
devices (a subprocess), and the entry point's emulated run of its flags
against the port's loop, bit for bit."""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_train_common import (ARGS, HIER_BATCH, HIER_K, HIER_SEQ,
                                 REF_HIER, STEPS, close, hier_loop,
                                 hier_twin, reference_hier_init)
from _torch_pg import REPO
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.utils.tree import tree_leaves


def test_lgc_rar_on_ring_packed_equals_mesh():
    """At K=2 the ring mean and the packed index wire are exact, so six
    lgc_rar steps through all three phases give the mesh run's losses and
    parameters bit for bit, while the bytes differ as priced."""
    from repro_torch.dist import plan as XP
    cfg = get_arch("llama3.2-1b").reduced()
    outs = {}
    for transport in ("mesh", "ring_packed"):
        args = train.parse_args(ARGS[:2] + ["6"] + ARGS[3:] + [
            "--warmup-steps", "2", "--ae-train-steps", "2", "--transport",
            transport, "--device", "cpu"])
        outs[transport] = train.run(cfg, args)
    mesh, packed = outs["mesh"], outs["ring_packed"]
    assert [h["phase"] for h in packed["history"]] == \
        ["warmup"] * 2 + ["topk_ae"] * 2 + ["compressed"] * 2
    assert [h["loss"] for h in packed["history"]] == \
        [h["loss"] for h in mesh["history"]]
    for a, b in zip(tree_leaves(packed["params"]),
                    tree_leaves(mesh["params"])):
        assert torch.equal(a, b)
    comp = packed["compressor"]
    for phase, rows in packed["wire"].items():
        plan = XP.build_plan(comp.cc, comp.layout, comp.K, phase=phase)
        assert rows == XP.wire_terms_by_op(plan, "ring_packed")
        assert rows != mesh["wire"][phase]


def test_ring_hier_trajectory_matches_reference_trainer(tmp_path,
                                                        monkeypatch):
    """Six lgc_rar steps (2 warm-up, 2 top-k + AE, 2 compressed) on
    ``ring_hier`` over a (2, 2) pod mesh: the reference's own training
    step (``repro.launch.steps``, what ``repro.launch.train --pod-shards 2
    --data-shards 2`` runs) on 4 host devices, a subprocess, against the
    port's LGCTrainStep with K = 4 nodes, Ks = (2, 2) (``hier_loop``),
    from the reference's initial weights and AE (``reference_hier_init``,
    checked equal to the subprocess's), node k on batch shard k: the
    losses to 1e-5, each phase's per-op rows exactly, the weights after
    six steps to 2e-5 of their largest value, as the other trajectories.
    And the entry point's emulated run of the same flags from the same
    weights (``hier_twin``, the twin of tests/test_torch_pg_train.py's
    process run) is that loop bit for bit: losses, rows, final params."""
    path = str(tmp_path / "hier.npz")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_HIER.format(
            STEPS=STEPS, BATCH=HIER_BATCH, SEQ=HIER_SEQ, path=path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 XLA_FLAGS="--xla_force_host_platform_device_count="
                           f"{HIER_K}"))
    try:
        init = reference_hier_init()
        np.savez(tmp_path / "init.npz", **init)
        losses, wire, params = hier_loop(init)
        twin = hier_twin(str(tmp_path / "init.npz"), monkeypatch)
        out, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert [h["loss"] for h in twin["history"]] == losses
    assert twin["wire"] == wire
    for a, b in zip(tree_leaves(twin["params"]), tree_leaves(params)):
        assert torch.equal(a, b)
    assert ref.returncode == 0 and "PASS" in out, out[-3000:]
    refd = dict(np.load(path))
    with open(path + ".json") as f:
        rwire = json.load(f)
    for key, a in init.items():
        assert np.array_equal(refd[key], a), key
    for step, loss in enumerate(losses):
        np.testing.assert_allclose(loss, float(refd[f"loss{step}"]),
                                   rtol=1e-5, err_msg=f"step {step}")
    assert list(wire) == ["warmup", "topk_ae", "compressed"]
    assert wire == rwire
    for i, a in enumerate(tree_leaves(params)):
        close(a.numpy(), refd[f"final{i}"], 2e-5, f"param leaf {i}")
