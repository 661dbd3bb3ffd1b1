"""The trainer under a process group: ``repro_torch.launch.train``'s
entry point in K = 4 processes (tests/_torch_pg_train_worker.py, one
gloo rank a node), six lgc_rar steps (2 warm-up, 2 top-k + AE, 2
compressed) on ``ring_hier`` over a (2, 2) pod mesh at ``reduced()``,
batch 8, seq 16, from the reference's initial weights and AE:

- bitwise the emulated run of the same flags in this process
  (``LGCTrainStep`` with the K nodes stacked): every step's loss, each
  phase's per-op rows on every rank, and the final params and AE (their
  digest, equal on every rank);
- the reference's own 4-device trainer (``_torch_train_common.REF_HIER``,
  run alongside in a subprocess) within the trajectory tests' bounds:
  losses to 1e-5, rows exactly, params to 2e-5 of their largest value.

And what a launch refuses: a world size other than pod x data shards,
no ``--dist-backend`` under torchrun (or one without it), and each flag
that does not run across processes yet, naming its ROADMAP item."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import _torch_pg_train_worker as W
from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_pg import REPO, launch, worker
from _torch_train_common import REF_HIER, STEPS, close
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import CompressionConfig as RCC
from repro.core import build_compressor as ref_build_compressor
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.dist.transport import PG_DEFERRED
from repro_torch.launch import train
from repro_torch.utils.tree import tree_leaves

K, BATCH, SEQ = 4, 8, 16
FLAGS = ["--smoke", "--steps", str(STEPS), "--batch", str(BATCH), "--seq",
         str(SEQ), "--compression", "lgc_rar", "--topk-backend", "fused",
         "--ae-backend", "pallas", "--transport", "ring_hier",
         "--pod-shards", "2", "--data-shards", "2", "--warmup-steps", "2",
         "--ae-train-steps", "2", "--optimizer", "sgd_momentum", "--lr",
         "0.1", "--log-every", "1", "--device", "cpu"]


def _reference_init(path):
    """The reference trainer's initial weights and AE (PRNGKey(0)) into
    ``path`` as p<i> / a<i>; returns them."""
    key = jax.random.PRNGKey(0)
    rparams = jax.jit(RefModel(ref_get_arch("llama3.2-1b").reduced()).init)(
        key)
    rcc = RCC(method="lgc_rar", warmup_steps=2, ae_train_steps=2)
    # jitted, as the reference's trainer draws it
    rae = jax.jit(lambda k: ref_build_compressor(rcc, rparams, K)
                  .init_state(k)["ae"])(key)
    out = {f"p{i}": np.asarray(a)
           for i, a in enumerate(jax.tree_util.tree_leaves(rparams))}
    out.update({f"a{i}": np.asarray(a)
                for i, a in enumerate(jax.tree_util.tree_leaves(rae))})
    np.savez(path, **out)
    return out


def test_process_trainer_matches_emulated_and_reference(tmp_path,
                                                        monkeypatch):
    ref_path = str(tmp_path / "ref.npz")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_HIER.format(STEPS=STEPS, BATCH=BATCH,
                                               SEQ=SEQ, path=ref_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    try:
        init = _reference_init(tmp_path / "init.npz")
        launch(tmp_path, worker("_torch_pg_train_worker.py") + [
            str(tmp_path / "init.npz")] + FLAGS + [
            "--dist-backend", "gloo", "--dist-init", "{store}", "--report",
            str(tmp_path / "ranks")], K, timeout=120)
        # the emulated twin, here, from the same weights (the wrapped
        # init is undone after the test)
        monkeypatch.setattr(W.steps.LGCTrainStep, "init",
                            W.steps.LGCTrainStep.init)
        W.start_from(str(tmp_path / "init.npz"))
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            monkeypatch.delenv(var, raising=False)
        cfg = get_arch("llama3.2-1b").reduced()
        emu = train.run(cfg, train.parse_args(
            FLAGS + ["--report", str(tmp_path / "emu")]))
        out, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0 and "PASS" in out, out[-3000:]
    losses = [h["loss"] for h in emu["history"]]
    for r in range(K):
        with open(tmp_path / "ranks" / f"rank{r}.json") as f:
            rec = json.load(f)
        assert [h["loss"] for h in rec["history"]] == losses, r
        assert rec["wire"] == emu["wire"], r
        assert rec["digest"] == emu["report"]["digest"], r
        # each rank sent its share: the pod ring's and the data ring's
        assert set(rec["sent"]) == set(emu["wire"]), r
    # against the reference's trainer
    refd = dict(np.load(ref_path))
    for key, a in init.items():
        assert np.array_equal(refd[key], a), key
    for step, loss in enumerate(losses):
        np.testing.assert_allclose(loss, float(refd[f"loss{step}"]),
                                   rtol=1e-5, err_msg=f"step {step}")
    with open(ref_path + ".json") as f:
        assert emu["wire"] == json.load(f)
    for i, a in enumerate(tree_leaves(emu["params"])):
        close(a.numpy(), refd[f"final{i}"], 2e-5, f"param leaf {i}")


def _torchrun_env(monkeypatch, world):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", str(world))


def _args(*extra):
    return train.parse_args(FLAGS + ["--steps", "1", *extra])


def test_world_size_must_hold_the_mesh(monkeypatch):
    _torchrun_env(monkeypatch, 3)
    with pytest.raises(ValueError, match="WORLD_SIZE=3"):
        train.run(get_arch("llama3.2-1b").reduced(),
                  _args("--dist-backend", "gloo"))


def test_backend_is_chosen_not_defaulted(monkeypatch):
    cfg = get_arch("llama3.2-1b").reduced()
    with pytest.raises(ValueError, match="torchrun"):
        train.run(cfg, _args("--dist-backend", "gloo"))
    _torchrun_env(monkeypatch, K)
    with pytest.raises(ValueError, match="--dist-backend"):
        train.run(cfg, _args())


@pytest.mark.parametrize("flags", [
    ["--transport", "chaos:ring_hier"], ["--fault-nans", "2"],
    ["--guard", "scrub"], ["--checkpoint-dir", "ckpt"], ["--resume",
                                                         "ckpt.npz"]],
    ids=["chaos", "fault", "guard", "checkpoint", "resume"])
def test_deferred_flags_raise(monkeypatch, flags):
    _torchrun_env(monkeypatch, K)
    with pytest.raises(NotImplementedError, match=PG_DEFERRED):
        train.run(get_arch("llama3.2-1b").reduced(),
                  _args("--dist-backend", "gloo", *flags))
