"""Two trajectories of the port's trainer on the emulated wires: lgc_rar
on ring_packed against the mesh run bit for bit, and ring_hier on a
(2, 2) pod mesh against the reference's own training step on 4 host
devices (a subprocess)."""
import jax
import numpy as np
import torch

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_train_common import ARGS, REF_HIER, STEPS, close
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import CompressionConfig as RCC
from repro.core import build_compressor as ref_build_compressor
from repro.data import synthetic_token_batches as ref_batches
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.core.phases import phase_for_step
from repro_torch.launch import train
from repro_torch.launch.steps import make_lgc_train_step
from repro_torch.models.model import build_model
from repro_torch.utils.convert import ae_from_numpy, params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_map


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


def test_ring_hier_trajectory_matches_reference_trainer(subproc, tmp_path):
    """Six lgc_rar steps (2 warm-up, 2 top-k + AE, 2 compressed) on
    ``ring_hier`` over a (2, 2) pod mesh: the reference's own training
    step (``repro.launch.steps``, what ``repro.launch.train --pod-shards 2
    --data-shards 2`` runs) on 4 host devices against the port's
    LGCTrainStep with K = 4 nodes, Ks = (2, 2), from the reference's
    initial weights and AE, node k on batch shard k: the losses to 1e-5,
    each phase's per-op rows exactly, the weights after six steps to
    2e-5 of their largest value, as the other trajectories."""
    import json
    batch, seq = 8, 16
    path = str(tmp_path / "hier.npz")
    assert "PASS" in subproc(REF_HIER.format(STEPS=STEPS, BATCH=batch,
                                             SEQ=seq, path=path), devices=4)
    ref = dict(np.load(path))
    with open(path + ".json") as f:
        rwire = json.load(f)
    rcfg = ref_get_arch("llama3.2-1b").reduced()
    key = jax.random.PRNGKey(0)
    pleaves, pdef = jax.tree_util.tree_flatten(
        jax.eval_shape(RefModel(rcfg).init, key))
    rparams = pdef.unflatten([ref[f"p{i}"] for i in range(len(pleaves))])
    rcc = RCC(method="lgc_rar", warmup_steps=2, ae_train_steps=2)
    rae = ref_build_compressor(rcc, rparams, 4).init_state(key)["ae"]
    aleaves, adef = jax.tree_util.tree_flatten(rae)
    cc = CompressionConfig(method="lgc_rar", warmup_steps=2,
                           ae_train_steps=2, transport="ring_hier",
                           topk_backend="fused", ae_backend="pallas")
    tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1,
                     steps=STEPS, compression=cc)
    lts = make_lgc_train_step(build_model(get_arch("llama3.2-1b").reduced()),
                              tc, 4, torch.device("cpu"), (2, 2))
    params = params_from_numpy(rparams)
    opt_state = lts.optimizer.init(params)
    state = lts.compressor.init_sim_states(torch.Generator())
    state["ae"] = ae_from_numpy(adef.unflatten(
        [ref[f"a{i}"] for i in range(len(aleaves))]))
    state["ae_mom"] = tree_map(torch.zeros_like, state["ae"])
    data = ref_batches(rcfg.vocab_size, batch, seq, seed=0)
    wire = {}
    for step in range(STEPS):
        phase = phase_for_step(step, cc)
        tbatch = {n: torch.from_numpy(x).long()
                  for n, x in next(data).items()}
        params, opt_state, state, metrics = lts.step(
            params, opt_state, state, tbatch, step, phase)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref[f"loss{step}"]), rtol=1e-5,
                                   err_msg=f"step {step} ({phase})")
        wire.setdefault(phase, metrics["wire"])
    assert list(wire) == ["warmup", "topk_ae", "compressed"]
    assert wire == rwire
    for i, a in enumerate(tree_leaves(params)):
        close(a.numpy(), ref[f"final{i}"], 2e-5, f"param leaf {i}")
