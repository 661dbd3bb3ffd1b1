"""The whole slice: the port's lgc_rar, sparse_gd and dgc trainers against
a reference loop built by hand from the JAX package (Model.loss + jax.grad
per node + GradientCompressor.sim_step with its jnp backends, which the
reference's own tests prove equal to its Pallas paths + build_optimizer),
for 6 steps with K=2 nodes through every phase; plus the entry point on
the CPU, its refusal to run without a card unless asked, and the import
rule."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import CompressionConfig as RCC
from repro.configs.base import TrainConfig as RTC
from repro.core import build_compressor as ref_build_compressor
from repro.core.phases import phase_for_step as ref_phase_for_step
from repro.data import synthetic_token_batches as ref_batches
from repro.dist import plan as RXP
from repro.models.model import Model as RefModel
from repro.optim.optimizers import build_optimizer as ref_build_optimizer
from repro.utils.tree import tree_flatten_vector as ref_flatten
from repro.utils.tree import tree_unflatten_vector as ref_unflatten
from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.core.phases import phase_for_step
from repro_torch.launch import train
from repro_torch.launch.steps import make_lgc_train_step
from repro_torch.models.model import build_model
from repro_torch.utils.convert import ae_from_numpy, params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_map, \
    tree_unflatten_vector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, STEPS, BATCH, SEQ = 2, 6, 4, 32
SLICE = dict(method="lgc_rar", warmup_steps=2, ae_train_steps=2)


def _close(a, b, rel, what):
    """|a - b| <= rel * max|b|: f32 sums in another order, compounded
    over the steps.  Measured on the CPU: <= 2.1e-6 for the global
    gradient, u, v and params, 1e-13 for the AE; bounds are ~10x that."""
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale,
                               err_msg=what)


def _trajectory(method, backend, ae_rel=1e-12):
    """6 steps of the reference loop (jnp backends) beside the port's
    pieces with ``backend`` (and the kernel encoder for lgc), the AE held
    to ``ae_rel`` of its largest value; returns the phases seen."""
    rcfg = ref_get_arch("llama3.2-1b").reduced()
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    slice_ = dict(SLICE, method=method)
    rcc = RCC(**slice_, topk_backend="jnp", ae_backend="jnp")
    # momentum SGD: linear in the gradient, so rounding differences stay
    # rounding-sized (AdamW's m/sqrt(v) turns a 1e-12-vs-0 gradient into a
    # full step; its own parity is test_adamw_matches_reference)
    ropt = ref_build_optimizer(RTC(optimizer="sgd_momentum",
                                   learning_rate=0.1, steps=STEPS,
                                   compression=rcc))
    ropt_state = ropt.init(rparams)
    rcomp = ref_build_compressor(rcc, rparams, K)
    rstates = rcomp.init_sim_states(jax.random.PRNGKey(1))
    rgrad = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))
    rsim = jax.jit(rcomp.sim_step, static_argnums=(3,))
    rupdate = jax.jit(ropt.update)

    cc = CompressionConfig(**slice_, topk_backend=backend,
                           ae_backend="pallas")
    tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1,
                     steps=STEPS, compression=cc)
    lts = make_lgc_train_step(build_model(get_arch("llama3.2-1b").reduced()),
                              tc, K, torch.device("cpu"))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams))
    opt_state = lts.optimizer.init(params)
    state = lts.compressor.init_sim_states(torch.Generator())
    lgc = "ae" in rstates
    if lgc:
        state["ae"] = ae_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           rstates["ae"]))
        state["ae_mom"] = tree_map(torch.zeros_like, state["ae"])

    data = ref_batches(rcfg.vocab_size, BATCH, SEQ, seed=0)
    phases = []
    for step in range(STEPS):
        phase = phase_for_step(step, cc)
        assert phase == ref_phase_for_step(step, rcc)
        phases.append(phase)
        batch = next(data)
        # reference: per-node grads -> sim_step -> optimizer
        flats, rloss = [], 0.0
        for k in range(K):
            nb = {n: x[k * BATCH // K:(k + 1) * BATCH // K]
                  for n, x in batch.items()}
            (loss_k, _), grads = rgrad(rparams, nb)
            flats.append(ref_flatten(grads))
            rloss += float(loss_k) / K
        rgg, rstates, _ = rsim(rstates, jnp.stack(flats), step, phase)
        rparams, ropt_state = rupdate(ref_unflatten(rgg, rparams),
                                      ropt_state, rparams, step)
        # the port: the same pieces LGCTrainStep.step runs
        tbatch = {n: torch.from_numpy(x).long() for n, x in batch.items()}
        g_nodes, metrics = lts.node_grads(params, tbatch)
        gg, state, stats = lts.compressor.sim_step(state, g_nodes, step,
                                                   phase)
        params, opt_state = lts.optimizer.update(
            tree_unflatten_vector(gg, params), opt_state, params, step)

        where = f"{method} step {step} ({phase})"
        np.testing.assert_allclose(float(metrics["loss"]), rloss,
                                   rtol=1e-5, err_msg=where)
        _close(gg.numpy(), rgg, 2e-5, where + " global gradient")
        if phase != "warmup":                 # the sent support, bitwise
            np.testing.assert_array_equal(gg.numpy() != 0,
                                          np.asarray(rgg) != 0, where)
        for key in ("u", "v"):
            ours, ref = state[key].numpy(), np.asarray(rstates[key])
            np.testing.assert_array_equal(ours == 0, ref == 0,
                                          f"{where} cleared {key}")
            _close(ours, ref, 2e-5, f"{where} {key}")
        if lgc:
            _close(torch.cat([a.reshape(-1)
                              for a in tree_leaves(state["ae"])]),
                   ref_flatten(rstates["ae"]), ae_rel, where + " ae")
        plan = RXP.build_plan(rcc, rcomp.layout, K, transport="mesh",
                              phase=phase)
        assert stats["wire"] == RXP.wire_terms_by_op(plan), where
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(rparams)):
        _close(a.numpy(), b, 2e-5, f"{method} params after 6 steps")
    return phases


def test_lgc_rar_trajectory_matches_reference():
    assert _trajectory("lgc_rar", "fused") == \
        ["warmup"] * 2 + ["topk_ae"] * 2 + ["compressed"] * 2


def test_lgc_ps_trajectory_matches_reference():
    """lgc_ps on the mesh wire: the K-decoder AE trained on the PS loss,
    then the leader's common encoding and every node's innovation,
    decoded per node and averaged.  The PS AE's gradient (K decoders, the
    similarity term) rounds differently in XLA and PyTorch: its trained
    weights were measured within 1.3e-9 of their largest value, held here
    to the 2e-5 of the other trajectory quantities."""
    assert _trajectory("lgc_ps", "fused", ae_rel=2e-5) == \
        ["warmup"] * 2 + ["topk_ae"] * 2 + ["compressed"] * 2


@pytest.mark.parametrize("backend", ["pallas", "fused"])
@pytest.mark.parametrize("method", ["sparse_gd", "dgc"])
def test_sparse_trajectory_matches_reference(method, backend):
    """sparse_gd and dgc, sparsified from the end of warm-up on: the
    reference with its jnp top-k beside the port's block top-k (K6's
    plain version, one per leaf) or fused sweep (K1's plain version,
    momentum off for sparse_gd); each node clears its own sent set."""
    assert _trajectory(method, backend) == ["warmup"] * 2 + ["topk_ae"] * 4


@pytest.mark.parametrize("method", ["none", "sparse_gd", "dgc", "lgc_rar",
                                    "lgc_ps", "lgc_rar_q8"])
def test_compressor_state_matches_reference(method):
    """init_state / init_sim_states: the same keys, leaf order and shapes
    as the reference's, with zero accumulators."""
    from repro.utils.tree import keystr_path as ref_keystr
    from repro_torch.core.compressors import build_compressor
    from repro_torch.utils.tree import keystr_path, tree_leaves_with_path
    shapes = {"embed": {"w": (9, 4)}, "block": {"w": (33, 16)}}
    rcomp = ref_build_compressor(
        RCC(method=method), {k: {n: jnp.zeros(s) for n, s in d.items()}
                             for k, d in shapes.items()}, K)
    comp = build_compressor(
        CompressionConfig(method=method),
        {k: {n: torch.zeros(s) for n, s in d.items()}
         for k, d in shapes.items()}, K)
    for ours, ref in ((comp.init_state(torch.Generator()),
                       rcomp.init_state(jax.random.PRNGKey(0))),
                      (comp.init_sim_states(torch.Generator()),
                       rcomp.init_sim_states(jax.random.PRNGKey(0)))):
        assert [(keystr_path(p), tuple(x.shape))
                for p, x in tree_leaves_with_path(ours)] == \
            [(ref_keystr(p), tuple(x.shape))
             for p, x in jax.tree_util.tree_leaves_with_path(ref)]
        assert not ours["u"].any() and not ours["v"].any()


@pytest.mark.parametrize("optimizer", ["adamw", "sgd_momentum"])
def test_optimizer_matches_reference(optimizer):
    """Three updates from the same params and gradients: params and
    moments to 1e-6 of their largest entry."""
    from repro.optim.optimizers import build_optimizer as rbuild
    from repro_torch.optim.optimizers import build_optimizer
    r = np.random.default_rng(0)
    p = {"a": {"w": r.standard_normal((7, 5)).astype(np.float32)},
         "b": r.standard_normal((11,)).astype(np.float32)}
    rtc = RTC(optimizer=optimizer, learning_rate=1e-2, steps=30)
    tc = TrainConfig(optimizer=optimizer, learning_rate=1e-2, steps=30)
    ropt, opt = rbuild(rtc), build_optimizer(tc)
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p)
    rs, ts = ropt.init(rp), opt.init(tp)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda x: r.standard_normal(x.shape).astype(np.float32), p)
        rp, rs = ropt.update(jax.tree_util.tree_map(jnp.asarray, g), rs,
                             rp, step)
        tp, ts = opt.update(params_from_numpy(g), ts, tp, step)
        for a, b in zip(tree_leaves(tp) + tree_leaves(ts),
                        jax.tree_util.tree_leaves(rp)
                        + jax.tree_util.tree_leaves(rs)):
            _close(a.numpy(), b, 1e-6, f"{optimizer} step {step}")


ARGS = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
        "--compression", "lgc_rar", "--topk-backend", "fused",
        "--ae-backend", "pallas", "--data-shards", "2",
        "--warmup-steps", "1", "--ae-train-steps", "1", "--log-every", "1"]


def test_main_runs_end_to_end_on_cpu():
    history = train.main(ARGS + ["--device", "cpu"])
    assert [h["phase"] for h in history] == ["warmup", "topk_ae",
                                             "compressed"]
    assert all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.parametrize("flags", [["--compression", "dgc",
                                    "--topk-backend", "pallas"],
                                   ["--compression", "sparse_gd",
                                    "--topk-backend", "fused"]])
def test_sparse_methods_run_end_to_end_on_cpu(flags):
    history = train.main(ARGS + flags + ["--device", "cpu"])
    assert [h["phase"] for h in history] == ["warmup", "topk_ae", "topk_ae"]
    assert all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.parametrize("flags", [["--compression", "dgc",
                                    "--topk-backend", "pallas"],
                                   ["--compression", "sparse_gd",
                                    "--topk-backend", "fused"],
                                   []])
def test_ring_packed_runs_end_to_end_on_cpu(flags):
    """The packed wire from the entry point: dgc and sparse_gd ship their
    packed top-k pairs, lgc_rar (ARGS) its packed support; each phase's
    byte rows are the ring_packed pricer's."""
    history = train.main(ARGS + flags + ["--transport", "ring_packed",
                                         "--device", "cpu"])
    assert all(np.isfinite(h["loss"]) for h in history)
    assert len(history) == 3


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


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS)


@pytest.mark.parametrize("flags", [["--compression", "lgc_ps"],
                                   ["--compression", "lgc_ps",
                                    "--transport", "ring_packed"],
                                   ["--compression", "lgc_rar_q8",
                                    "--transport", "ring_q8"]])
def test_ps_q8_run_end_to_end_on_cpu(flags):
    """lgc_ps (mesh and the packed ring) and lgc_rar_q8 on the int8 ring
    from the entry point, through all three phases, each phase's byte
    rows the pricer's for the run's transport."""
    from repro_torch.dist import plan as XP
    args = train.parse_args(ARGS + flags + ["--device", "cpu"])
    out = train.run(get_arch("llama3.2-1b").reduced(), args)
    assert [h["phase"] for h in out["history"]] == ["warmup", "topk_ae",
                                                    "compressed"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    comp = out["compressor"]
    for phase, rows in out["wire"].items():
        plan = XP.build_plan(comp.cc, comp.layout, comp.K, phase=phase)
        assert rows == XP.wire_terms_by_op(plan)
    if "lgc_ps" in flags:
        assert out["rate"].bytes_leader > out["rate"].bytes_other


@pytest.mark.parametrize("flags", [["--transport", "chaos:mesh"],
                                   ["--guard", "scrub"]])
def test_unported_options_raise(flags):
    """The chaos wire with no fault set, and the scrub guard on a clean
    wire (the test's name is from before either was ported): the plain
    mesh run's losses bit for bit; under the guard every step is clean
    and counts no fault."""
    plain = train.main(ARGS + ["--device", "cpu"])
    history = train.main(ARGS + flags + ["--device", "cpu"])
    assert [h["loss"] for h in history] == [h["loss"] for h in plain]
    if "--guard" in flags:
        assert all(h["guard_ok"] == 1 and h["faults"] == 0
                   and set(h["fault"].values()) == {0} for h in history)
    assert all("fault_ops" not in h for h in history)


@pytest.mark.parametrize("flags", [["--transport", "ring_hier",
                                    "--pod-shards", "2", "--data-shards",
                                    "2", "--batch", "4"],
                                   ["--transport", "ring_packed",
                                    "--wire-buckets", "2"]])
def test_hier_and_bucketed_wires_run_end_to_end_on_cpu(flags):
    """The hierarchical ring on a (2, 2) pod mesh and the bucketed packed
    ring from the entry point, through all three phases: finite losses,
    and each phase's byte rows (``#b<i>`` rows where bucketed) the
    pricer's for the run's mesh."""
    from repro_torch.dist import plan as XP
    args = train.parse_args(ARGS + flags + ["--device", "cpu"])
    out = train.run(get_arch("llama3.2-1b").reduced(), args)
    assert [h["phase"] for h in out["history"]] == ["warmup", "topk_ae",
                                                    "compressed"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    comp = out["compressor"]
    assert comp.K == args.pod_shards * args.data_shards
    for phase, rows in out["wire"].items():
        plan = XP.build_plan(comp.cc, comp.layout, comp.K, phase=phase)
        assert rows == XP.wire_terms_by_op(plan, axis_sizes=comp.Ks)
    kinds = {k for rows in out["wire"].values() for row in rows.values()
             for k in row}
    if "ring_hier" in flags:
        assert {"ring_hier_intra", "ring_hier_inter"} <= kinds
    else:
        assert any("#b" in op for op in out["wire"]["compressed"])


REF_HIER = """
import numpy as np, jax, jax.flatten_util
import jax.tree_util as jtu
from repro.configs import get_arch
from repro.configs.base import CompressionConfig, TrainConfig
from repro.core.phases import phase_for_step
from repro.data import synthetic_token_batches
from repro.dist import collectives as coll
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_lgc_train_step
from repro.models import build_model
import json

cfg = get_arch("llama3.2-1b").reduced()
model = build_model(cfg)
cc = CompressionConfig(method="lgc_rar", warmup_steps=2, ae_train_steps=2,
                       transport="ring_hier", topk_backend="jnp",
                       ae_backend="jnp")
tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1,
                 steps={STEPS}, compression=cc)
mesh = make_host_mesh(2, 1, pod=2)
lts = make_lgc_train_step(model, tc, mesh)
params, opt_state, comp_state = lts.init(jax.random.PRNGKey(0), model, mesh)
out = {{f"p{{i}}": np.asarray(a)
       for i, a in enumerate(jtu.tree_leaves(params))}}
out.update({{f"a{{i}}": np.asarray(a)
            for i, a in enumerate(jtu.tree_leaves(comp_state["ae"]))}})
data = synthetic_token_batches(cfg.vocab_size, {BATCH}, {SEQ}, seed=0)
fns, wire = {{}}, {{}}
for step in range({STEPS}):
    phase = phase_for_step(step, cc)
    batch = next(data)
    new = phase not in fns
    if new:
        coll.reset_wire_tally()
        fns[phase] = lts.make_step(phase, jtu.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch))
    params, opt_state, comp_state, metrics = fns[phase](
        params, opt_state, comp_state, batch, step)
    out[f"loss{{step}}"] = np.float64(metrics["loss"])
    if new:
        wire[phase] = coll.wire_report(by_op=True)
out.update({{f"final{{i}}": np.asarray(a)
            for i, a in enumerate(jtu.tree_leaves(params))}})
np.savez({path!r}, **out)
with open({path!r} + ".json", "w") as f:
    json.dump(wire, f)
print("PASS")
"""


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
        _close(a.numpy(), ref[f"final{i}"], 2e-5, f"param leaf {i}")


def test_port_imports_neither_jax_nor_reference():
    root = os.path.join(REPO, "src", "repro_torch")
    bad = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for node in ast.walk(ast.parse(open(path).read())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "repro"):
                        bad.append((path, n))
    assert not bad, bad
    assert os.path.exists(os.path.join(root, "kernels", "csrc",
                                       "sparsify_ef.cu"))
