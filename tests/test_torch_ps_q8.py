"""The port's parameter-server LGC (``lgc_ps``) and int8-wire LGC
(``lgc_rar_q8``) against the JAX reference: the innovation selection
(bitwise, tied magnitudes), the K-decoder PS autoencoder (init layout,
carried weights, decode, loss and gradients to 1e-5), the fake-quantized
node mean (bitwise against the jitted reference), the exchange plan and
its pricing (leader and other payloads), one compressor step per phase
on the mesh wire, and 6-step trajectories on the wires that quantize:
``lgc_ps`` on ``ring_packed`` and ``lgc_rar_q8`` on ``ring_q8``, against
the reference's ``dist_step`` under ``shard_map`` on 2 host devices (one
subprocess per module, ``conftest.run_py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import CompressionConfig as RCC
from repro.core import autoencoder as RAE
from repro.core import build_compressor as ref_build_compressor
from repro.core import rate as RRATE
from repro.core import sparsify as RSP
from repro.data import synthetic_token_batches as ref_batches
from repro.dist import plan as RXP
from repro.dist.transport import make_transport as ref_make_transport
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.core import autoencoder as AE
from repro_torch.core import rate as RATE
from repro_torch.core import sparsify as SP
from repro_torch.core.compressors import build_compressor
from repro_torch.core.phases import phase_for_step
from repro_torch.dist import plan as XP
from repro_torch.dist.transport import make_transport
from repro_torch.launch.steps import make_lgc_train_step
from repro_torch.models.model import build_model
from repro_torch.utils.convert import ae_from_numpy, params_from_numpy
from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path,
                                    tree_unflatten, tree_unflatten_vector)

TOL = dict(rtol=1e-5, atol=1e-5)
K, STEPS, BATCH, SEQ = 2, 6, 4, 32
WIRES = [("lgc_ps", "ring_packed"), ("lgc_rar_q8", "ring_q8")]
SHAPES = {"embed": {"w": (11, 3)}, "block1": {"w": (57, 31), "b": (13,)},
          "block2": {"w": (41, 29)}, "fc": {"w": (17, 19)}}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=2)
def _ref_ps_ae(Kd):
    return _np(RAE.init_lgc_autoencoder(jax.random.PRNGKey(3),
                                        num_decoders=Kd, ps_innovation=True))


# -- innovation selection ------------------------------------------------------


@pytest.mark.parametrize("frac", [0.01, 0.2, 1.0])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_select_innovation_matches_reference(kind, frac):
    r = np.random.default_rng(int(frac * 100))
    x = r.standard_normal(1000).astype(np.float32)
    if kind == "ties":                     # nearly every magnitude tied
        x = r.integers(-3, 4, 1000).astype(np.float32)
    assert SP.innovation_k(1000, frac) == RSP.innovation_k(1000, frac)
    vec, idx = SP.select_innovation(torch.from_numpy(x), frac)
    rvec, ridx = RSP.select_innovation(jnp.asarray(x), frac)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(_bits(vec.numpy()), _bits(rvec))
    assert idx.dtype == torch.int32


def test_innovation_frac_and_k_match_reference():
    for mu in (1, 16, 999, 243296, 10 ** 7):
        for inno, alpha in ((1e-5, 1e-3), (1e-4, 1e-3), (0.0, 0.0)):
            f = SP.innovation_frac(inno, alpha)
            assert f == RSP.innovation_frac(inno, alpha)
            assert SP.innovation_k(mu, f) == RSP.innovation_k(mu, f)


# -- the PS autoencoder ----------------------------------------------------------


@pytest.mark.parametrize("Kd", [1, 3])
def test_ps_autoencoder_layout_and_carry(Kd):
    """init_lgc_autoencoder's K stacked decoders (plus the innovation
    channel) have the reference's keys, leaf order and shapes, and
    ae_from_numpy carries a reference PS autoencoder across unchanged."""
    ref = _ref_ps_ae(Kd)
    ours = AE.init_lgc_autoencoder(torch.Generator().manual_seed(0),
                                   num_decoders=Kd, ps_innovation=True)
    assert [(keystr_path(p), tuple(x.shape))
            for p, x in tree_leaves_with_path(ours)] == \
        [(jax.tree_util.keystr(p, simple=True, separator="/"), x.shape)
         for p, x in jax.tree_util.tree_leaves_with_path(ref)]
    carried = ae_from_numpy(ref)
    for a, b in zip(tree_leaves(carried), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("Kd,L", [(3, 64), (2, 256)])
def test_lgc_decode_ps_matches_reference(Kd, L):
    ref = _ref_ps_ae(Kd)
    ae = ae_from_numpy(ref)
    r = np.random.default_rng(L)
    z = r.standard_normal((L // 16, 4)).astype(np.float32)
    inno = (r.standard_normal((Kd, L)) * (r.random((Kd, L)) < 0.1)
            ).astype(np.float32)
    rec = AE.lgc_decode_ps(ae, torch.from_numpy(z), torch.from_numpy(inno))
    rrec = jax.jit(RAE.lgc_decode_ps)(ref, z, inno)
    assert tuple(rec.shape) == (Kd, L)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rrec), **TOL)


@pytest.mark.parametrize("Kd,L,common", [(3, 256, 1), (2, 1024, 0)])
def test_ae_loss_ps_and_grads_match_reference(Kd, L, common):
    ref = _ref_ps_ae(Kd)
    ae = ae_from_numpy(ref)
    r = np.random.default_rng(Kd * L)
    g = (r.standard_normal((Kd, L)) * 0.01).astype(np.float32)
    inno = np.where(r.random((Kd, L)) < 0.05, g, 0).astype(np.float32)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(ae)]
    loss, parts = AE.ae_loss_ps(tree_unflatten(ae, leaves),
                                torch.from_numpy(g), torch.from_numpy(inno),
                                common, 1.0, 0.5)
    grads = torch.autograd.grad(loss, leaves)

    def rloss_fn(p):
        return RAE.ae_loss_ps(p, g, inno, common, 1.0, 0.5)
    (rloss, rparts), rgrads = jax.jit(jax.value_and_grad(
        rloss_fn, has_aux=True))(ref)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
    for key in ("l_rec", "l_sim"):
        np.testing.assert_allclose(parts[key].item(), float(rparts[key]),
                                   rtol=1e-5)
    rleaves = jax.tree_util.tree_leaves(rgrads)
    assert len(rleaves) == len(grads)
    for a, b in zip(grads, rleaves):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-12)
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   rtol=0, atol=1e-5)


# -- the fake-quantized mean -------------------------------------------------------


@pytest.mark.parametrize("Kn", [2, 3, 5])
@pytest.mark.parametrize("scale_block", [0, 64])
def test_sim_mean_q8_matches_jitted_reference(Kn, scale_block):
    """SimTransport.mean_q8 (each node's int8 round trip, then the node
    mean) bitwise against the reference's jitted SimTransport: XLA fuses
    each node's dequantize into the sum as an FMA, and the port does the
    same; the tally is the f32 mean's."""
    r = np.random.default_rng(Kn + scale_block)
    x = (r.standard_normal((Kn, 300, 7)) * np.logspace(-3, 2, 7)
         ).astype(np.float32)
    x[0, 5, 3] = np.nan                    # a non-finite input quantizes to 0
    ref = np.asarray(jax.jit(ref_make_transport(
        "sim", Kn, scale_block=scale_block).mean_q8)(x))
    t = make_transport("mesh", Kn, scale_block)
    with t.wire_op("x"):
        got = t.mean_q8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert t.tally == {"x": {"all_reduce": 2 * (Kn - 1) / Kn * x[0].nbytes}}


# -- plan and pricing ----------------------------------------------------------------


def _layouts(which, sparsity):
    if which == "odd":
        ref = {k: {n: jnp.zeros(s) for n, s in d.items()}
               for k, d in SHAPES.items()}
        ours = {k: {n: torch.zeros(s) for n, s in d.items()}
                for k, d in SHAPES.items()}
        return SP.build_layout(ours, sparsity), RSP.build_layout(ref,
                                                                 sparsity)
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), n_layers=4)
    rcfg = dataclasses.replace(ref_get_arch("llama3.2-1b"), n_layers=4)
    return (SP.build_layout(build_model(cfg).init(torch.Generator(), "meta"),
                            sparsity),
            RSP.build_layout(jax.eval_shape(RefModel(rcfg).init,
                                            jax.random.PRNGKey(0)), sparsity))


@pytest.mark.parametrize("which,sparsity", [("odd", 0.05),
                                            ("llama4", 0.001)])
@pytest.mark.parametrize("method", ["lgc_ps", "lgc_rar_q8"])
@pytest.mark.parametrize("Kn", [2, 4])
def test_ps_q8_plan_and_pricing_match_reference(which, sparsity, method, Kn):
    """build_plan per phase (labels, op types, the innovations' PackPlan),
    wire_terms_by_op, rate_terms and rate_report (leader and other) on
    mesh, ring, ring_q8 and ring_packed, equal to the reference's."""
    layout, rlayout = _layouts(which, sparsity)
    rng = np.random.default_rng(Kn)
    idx = np.sort(rng.choice(layout.n_total, layout.mu_pad, replace=False)
                  ).astype(np.int32)
    k_inv = RSP.innovation_k(layout.mu_pad, RSP.innovation_frac(1e-5,
                                                                sparsity))
    inno = np.sort(rng.choice(layout.mu_pad, k_inv, replace=False)
                   ).astype(np.int32)
    for scale_block in (0, 64):
        cc = CompressionConfig(method=method, sparsity=sparsity,
                               q8_scale_block=scale_block)
        rcc = RCC(method=method, sparsity=sparsity,
                  q8_scale_block=scale_block)
        for tk in ("mesh", "ring", "ring_q8", "ring_packed"):
            for phase in ("warmup", "topk_ae", "compressed", None):
                plan = XP.build_plan(cc, layout, Kn, transport=tk,
                                     phase=phase)
                rplan = RXP.build_plan(rcc, rlayout, Kn, transport=tk,
                                       phase=phase)
                assert (plan.phase, plan.labels) == (rplan.phase,
                                                     rplan.labels)
                for op, rop in zip(plan.ops, rplan.ops):
                    assert type(op).__name__ == type(rop).__name__
                    if isinstance(op, XP.PackedSparseExchange):
                        assert (op.mode, op.k, op.n_vec) == \
                            (rop.mode, rop.k, rop.n_vec)
                        assert (op.pack is None) == (rop.pack is None)
                        if op.pack is not None:
                            assert dataclasses.astuple(op.pack) == \
                                dataclasses.astuple(rop.pack)
                    if isinstance(op, XP.Reduce):
                        assert op.wire == rop.wire
                assert XP.wire_terms_by_op(plan) == \
                    RXP.wire_terms_by_op(rplan)
                for ce in (True, False):
                    assert XP.rate_terms(plan, count_exempt=ce) == \
                        RXP.rate_terms(rplan, count_exempt=ce)
            for kw in ({}, {"indices": idx, "inno_indices": inno},
                       {"count_exempt": False}):
                ours = RATE.rate_report(cc, layout, Kn, transport=tk, **kw)
                ref = RRATE.rate_report(rcc, rlayout, Kn, transport=tk, **kw)
                assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
                if method == "lgc_ps":
                    assert ours.bytes_leader > ours.bytes_other


# -- one step per phase on the mesh wire ---------------------------------------------


@pytest.mark.parametrize("phase", ["warmup", "topk_ae", "compressed"])
@pytest.mark.parametrize("method", ["lgc_ps", "lgc_rar_q8"])
def test_sim_step_matches_reference(method, phase):
    """One GradientCompressor.sim_step per phase on the mesh wire (K = 3,
    the leader node 1) against the reference's jitted sim_step on the
    same accumulators and AE: u, v and the support bitwise; the gradient
    bitwise where no decoder ran, else within 2e-5 of its largest value
    (lgc_ps) or the int8 bound 2e-3 (lgc_rar_q8); the AE after the top-k
    phase to 1e-5 of its largest value; the wire rows equal the
    reference's pricer."""
    Kn, step = 3, 4
    layout, rlayout = _layouts("odd", 0.05)
    kw = dict(method=method, sparsity=0.05, warmup_steps=1, ae_train_steps=1)
    cc, rcc = CompressionConfig(**kw), RCC(**kw)
    rparams = {k: {n: jnp.zeros(s) for n, s in d.items()}
               for k, d in SHAPES.items()}
    rcomp = ref_build_compressor(rcc, rparams, Kn)
    comp = build_compressor(cc, {k: {n: torch.zeros(s) for n, s in d.items()}
                                 for k, d in SHAPES.items()}, Kn)
    r = np.random.default_rng(11)
    u, v, g = ((r.standard_normal((Kn, layout.n_total)) * 0.01
                ).astype(np.float32) for _ in range(3))
    rst = rcomp.init_sim_states(jax.random.PRNGKey(0))
    rst.update(u=jnp.asarray(u), v=jnp.asarray(v))
    rgg, rst2, _ = jax.jit(rcomp.sim_step, static_argnums=(3,))(
        rst, jnp.asarray(g), step, phase)
    st = comp.init_sim_states(torch.Generator())
    st.update(u=torch.from_numpy(u.copy()), v=torch.from_numpy(v.copy()),
              ae=ae_from_numpy(_np(rst["ae"])),
              ae_mom=ae_from_numpy(_np(rst["ae_mom"])))
    gg, st2, stats = comp.sim_step(st, torch.from_numpy(g), step, phase)
    rgg = np.asarray(rgg)
    np.testing.assert_array_equal(gg.numpy() != 0, rgg != 0)
    if phase == "compressed":
        tol = 2e-3 if method == "lgc_rar_q8" else 2e-5 * np.abs(rgg).max()
        np.testing.assert_allclose(gg.numpy(), rgg, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(_bits(gg.numpy()), _bits(rgg))
    for key in ("u", "v"):
        np.testing.assert_array_equal(_bits(st2[key].numpy()),
                                      _bits(rst2[key]))
    ae = torch.cat([a.reshape(-1) for a in tree_leaves(st2["ae"])]).numpy()
    rae = np.concatenate([np.asarray(b).reshape(-1) for b in
                          jax.tree_util.tree_leaves(rst2["ae"])])
    np.testing.assert_allclose(ae, rae, rtol=0, atol=1e-5 * np.abs(rae).max())
    plan = RXP.build_plan(rcc, rlayout, Kn, transport="mesh", phase=phase)
    assert stats["wire"] == RXP.wire_terms_by_op(plan)


# -- 6-step trajectories on the quantizing wires ------------------------------------

REF_TRAJ = """
import numpy as np, jax, jax.flatten_util, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_arch
from repro.configs.base import CompressionConfig, TrainConfig
from repro.core import build_compressor
from repro.core.phases import phase_for_step
from repro.data import synthetic_token_batches
from repro.models.model import Model
from repro.optim.optimizers import build_optimizer
from repro.utils.tree import tree_flatten_vector, tree_unflatten_vector

K, STEPS, BATCH, SEQ, WIRES = {K}, {STEPS}, {BATCH}, {SEQ}, {WIRES!r}
mesh = jax.make_mesh((K,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
cfg = get_arch("llama3.2-1b").reduced()
model = Model(cfg)
rgrad = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
out = {{}}
for method, tkind in WIRES:
    params = model.init(jax.random.PRNGKey(0))
    cc = CompressionConfig(method=method, warmup_steps=2, ae_train_steps=2,
                           topk_backend="jnp", ae_backend="jnp",
                           transport=tkind)
    opt = build_optimizer(TrainConfig(optimizer="sgd_momentum",
                                      learning_rate=0.1, steps=STEPS,
                                      compression=cc))
    opt_state = opt.init(params)
    update = jax.jit(opt.update)
    comp = build_compressor(cc, params, K)
    st = comp.init_sim_states(jax.random.PRNGKey(1))
    u, v = st["u"], st["v"]
    aux = {{k: st[k] for k in ("ae", "ae_mom")}}
    fns = {{}}

    def make(phase):
        def inner(u, v, g, aux, step):
            state = {{"u": u[0], "v": v[0], **aux}}
            gg, s2, _ = comp.dist_step(state, g[0], step, phase, ("data",),
                                       transport=tkind)
            return (gg[None], s2["u"][None], s2["v"][None],
                    {{k: s2[k] for k in aux}})
        return jax.jit(jax.shard_map(
            inner, mesh=mesh, in_specs=(P("data"),) * 3 + (P(), P()),
            out_specs=(P("data"),) * 3 + (P(),), axis_names={{"data"}},
            check_vma=False))
    data = synthetic_token_batches(cfg.vocab_size, BATCH, SEQ, seed=0)
    for step in range(STEPS):
        phase = phase_for_step(step, cc)
        batch = next(data)
        flats, loss = [], 0.0
        for k in range(K):
            nb = {{n: x[k * BATCH // K:(k + 1) * BATCH // K]
                  for n, x in batch.items()}}
            (lk, _), grads = rgrad(params, nb)
            flats.append(tree_flatten_vector(grads))
            loss += float(lk) / K
        if phase not in fns:
            fns[phase] = make(phase)
        gg, u, v, aux = fns[phase](u, v, jnp.stack(flats), aux,
                                   jnp.int32(step))
        gg = gg[0]
        params, opt_state = update(tree_unflatten_vector(gg, params),
                                   opt_state, params, step)
        key = method + "/" + str(step)
        out[key + "/loss"] = np.float64(loss)
        out[key + "/g"], out[key + "/u"] = np.asarray(gg), np.asarray(u)
        out[key + "/v"] = np.asarray(v)
        out[key + "/ae"] = np.asarray(
            jax.flatten_util.ravel_pytree(aux["ae"])[0])
    out[method + "/params"] = np.asarray(tree_flatten_vector(params))
np.savez({path!r}, **out)
print("PASS")
"""


@pytest.fixture(scope="module")
def ref_trajectories(subproc, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_ps_q8") / "traj.npz")
    code = REF_TRAJ.format(K=K, STEPS=STEPS, BATCH=BATCH, SEQ=SEQ,
                           WIRES=WIRES, path=path)
    assert "PASS" in subproc(code, devices=K)
    return dict(np.load(path))


def _close(a, b, rel, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("method,transport", WIRES)
def test_wire_trajectory_matches_reference(ref_trajectories, method,
                                           transport):
    """Six steps (2 warm-up, 2 top-k + AE, 2 compressed) with K = 2 on the
    wire that quantizes (lgc_ps on ring_packed: the exempt-last pairs and
    the innovations ship int8 values; lgc_rar_q8 on ring_q8: the
    encoding mean is the int8 ring), from the reference's weights and AE,
    against its dist_step: the support and the cleared coordinates
    bitwise, the gradient, u, v, the AE and the parameters to 2e-5 of
    their largest value, as the mesh trajectories."""
    ref = ref_trajectories
    rcfg = ref_get_arch("llama3.2-1b").reduced()
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    rcc = RCC(method=method, warmup_steps=2, ae_train_steps=2)
    rcomp = ref_build_compressor(rcc, rparams, K)
    rst = rcomp.init_sim_states(jax.random.PRNGKey(1))
    cc = CompressionConfig(method=method, warmup_steps=2, ae_train_steps=2,
                           topk_backend="fused", ae_backend="pallas",
                           transport=transport)
    tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1,
                     steps=STEPS, compression=cc)
    lts = make_lgc_train_step(build_model(get_arch("llama3.2-1b").reduced()),
                              tc, K, torch.device("cpu"))
    params = params_from_numpy(_np(rparams))
    opt_state = lts.optimizer.init(params)
    state = lts.compressor.init_sim_states(torch.Generator())
    state["ae"] = ae_from_numpy(_np(rst["ae"]))
    state["ae_mom"] = ae_from_numpy(_np(rst["ae_mom"]))
    data = ref_batches(rcfg.vocab_size, BATCH, SEQ, seed=0)
    phases = []
    for step in range(STEPS):
        phase = phase_for_step(step, cc)
        phases.append(phase)
        batch = {n: torch.from_numpy(x).long() for n, x in next(data).items()}
        g_nodes, metrics = lts.node_grads(params, batch)
        gg, state, stats = lts.compressor.sim_step(state, g_nodes, step,
                                                   phase)
        params, opt_state = lts.optimizer.update(
            tree_unflatten_vector(gg, params), opt_state, params, step)
        key, where = f"{method}/{step}", f"{method} step {step} ({phase})"
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref[key + "/loss"]), rtol=1e-5,
                                   err_msg=where)
        _close(gg.numpy(), ref[key + "/g"], 2e-5, where + " global gradient")
        if phase != "warmup":
            np.testing.assert_array_equal(gg.numpy() != 0,
                                          ref[key + "/g"] != 0, where)
        for name in ("u", "v"):
            ours, want = state[name].numpy(), ref[f"{key}/{name}"]
            np.testing.assert_array_equal(ours == 0, want == 0,
                                          f"{where} cleared {name}")
            _close(ours, want, 2e-5, f"{where} {name}")
        _close(torch.cat([a.reshape(-1) for a in tree_leaves(state["ae"])]),
               ref[key + "/ae"], 2e-5, where + " ae")
        plan = XP.build_plan(cc, lts.compressor.layout, K, phase=phase)
        assert stats["wire"] == XP.wire_terms_by_op(plan), where
    assert phases == ["warmup"] * 2 + ["topk_ae"] * 2 + ["compressed"] * 2
    _close(torch.cat([a.reshape(-1).float() for a in tree_leaves(params)]),
           ref[method + "/params"], 2e-5, f"{method} params after 6 steps")
