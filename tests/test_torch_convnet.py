"""The port's ConvNet5 slice against the JAX reference: the image stream
bit for bit; the forward, loss, accuracy and gradients with the
reference's weights carried across (the smoke config, the paper's widths
at a small batch, and an odd image size that pins XLA's asymmetric SAME
padding); the information plane; the compressor's layout; and 6-step
trajectories of the reference's single-host ConvNet5 loop
(``tests/test_system.py``'s): ``lgc_rar`` with the fused sweep and the
kernel encoder on the mesh wire, against the reference's ``sim_step``,
and ``dgc`` with the block top-k on the packed ring, against the
reference's ``dist_step`` on ``ring_packed`` under ``shard_map`` on 2
host devices (the packed ring ships int8 values, so the reference's f32
``sim_step`` is not its counterpart)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressionConfig as RCC
from repro.configs.convnet5 import config as ref_config
from repro.configs.convnet5 import smoke_config as ref_smoke_config
from repro.core import build_compressor as ref_build_compressor
from repro.core import info_theory as RIT
from repro.core import sparsify as RSP
from repro.core.phases import phase_for_step as ref_phase_for_step
from repro.data import synthetic_image_batches as ref_images
from repro.models import convnet as RCN
from repro.utils.tree import tree_flatten_vector as ref_flatten
from repro.utils.tree import tree_unflatten_vector as ref_unflatten
from repro_torch.configs.base import CompressionConfig
from repro_torch.configs.convnet5 import config, smoke_config
from repro_torch.core import info_theory as IT
from repro_torch.core import sparsify as SP
from repro_torch.core.compressors import build_compressor
from repro_torch.data import synthetic_image_batches
from repro_torch.dist import plan as XP
from repro_torch.examples import information_plane as example
from repro_torch.launch.steps import sim_sgd_step
from repro_torch.models import convnet as CN
from repro_torch.utils.convert import ae_from_numpy, params_from_numpy
from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path, tree_unflatten)

K, STEPS, PER_NODE, LR = 2, 6, 4, 0.08


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, rel, what):
    """|a - b| <= rel * max|b|."""
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


def _configs(which):
    if which == "smoke":
        return ref_smoke_config(), smoke_config()
    if which == "full":
        return ref_config(), config()
    # odd sizes: 15 -> 15 -> 8 (pad (1, 1)) -> 8 -> 4 (pad (0, 1))
    return (dataclasses.replace(ref_smoke_config(), image_size=15),
            dataclasses.replace(smoke_config(), image_size=15))


@functools.lru_cache(maxsize=4)
def _ref_params(which):
    rcfg, _ = _configs(which)
    return _np(RCN.init_convnet5(jax.random.PRNGKey(0), rcfg))


def test_image_stream_matches_reference():
    for args in ((10, 8, 16), (200, 3, 32, 3, 7)):
        ours, ref = synthetic_image_batches(*args), ref_images(*args)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("which,batch", [("smoke", 8), ("full", 2),
                                         ("odd", 4)])
def test_forward_loss_and_grads_match_reference(which, batch):
    """Logits and every gradient leaf to 1e-5 of their largest entry, the
    loss to rtol 1e-5, the accuracy equal: f32 sums in another order
    (measured on the CPU: <= 1.9e-6 of the leaf's largest entry)."""
    rcfg, cfg = _configs(which)
    rparams = _ref_params(which)
    rbatch = next(ref_images(rcfg.num_classes, batch, rcfg.image_size,
                             seed=1))
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RCN.convnet5_loss(p, rcfg, b), has_aux=True))(
            rparams, rbatch)
    rlogits = jax.jit(lambda p, x: RCN.convnet5_forward(p, rcfg, x))(
        rparams, rbatch["images"])
    tree = params_from_numpy(rparams)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tree)]
    tbatch = {k: torch.from_numpy(v) for k, v in rbatch.items()}
    loss, metrics = CN.convnet5_loss(tree_unflatten(tree, leaves), cfg,
                                     tbatch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        logits = CN.convnet5_forward(tree, cfg, tbatch["images"])
    assert tuple(logits.shape) == (batch, cfg.num_classes)
    _close(logits.numpy(), rlogits, 1e-5, f"{which} logits")
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
    assert float(metrics["accuracy"]) == float(rmetrics["accuracy"])
    paths = [keystr_path(p) for p, _ in tree_leaves_with_path(tree)]
    rleaves = jax.tree_util.tree_leaves(rgrads)
    assert len(rleaves) == len(grads)
    for path, a, b in zip(paths, grads, rleaves):
        _close(a.numpy(), b, 1e-5, f"{which} d/d {path}")


def test_same_padding_is_xla_s():
    """The forward's padding rule against lax's SAME rule at every size
    up to 40, for the 3x3 window at strides 1 and 2."""
    for s in (1, 2):
        for size in range(1, 41):
            want = jax.lax.padtype_to_pads((size,), (3,), (s,), "SAME")[0]
            assert CN._same_pad(size, 3, s) == tuple(want), (size, s)


def test_init_is_seeded_and_shaped_like_reference():
    """The reference's tree (paths, shapes, f32), seeded, with its
    scales: He-normal convs, a 1/sqrt(fan_in) classifier, BN scale 1 and
    bias 0 (std of each weight within 5% of its scale)."""
    ref = _ref_params("full")
    ours = CN.init_convnet5(torch.Generator().manual_seed(0), config())
    again = CN.init_convnet5(torch.Generator().manual_seed(0), config())
    assert [(keystr_path(p), tuple(x.shape))
            for p, x in tree_leaves_with_path(ours)] == \
        [(jax.tree_util.keystr(p, simple=True, separator="/"), x.shape)
         for p, x in jax.tree_util.tree_leaves_with_path(ref)]
    for a, b in zip(tree_leaves(ours), tree_leaves(again)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    c_in = 3
    for i, c_out in enumerate(config().channels):
        p = ours[f"conv{i}"]
        np.testing.assert_allclose(float(p["w"].std()),
                                   np.sqrt(2.0 / (9 * c_in)), rtol=0.05)
        assert torch.equal(p["bn_scale"], torch.ones(c_out))
        assert torch.equal(p["bn_bias"], torch.zeros(c_out))
        c_in = c_out
    np.testing.assert_allclose(float(ours["fc"]["w"].std()),
                               np.sqrt(1.0 / c_in), rtol=0.05)
    assert not ours["fc"]["b"].any()


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("sparsity", [0.001, 0.01, 0.05])
def test_layout_matches_reference(which, sparsity):
    """n, mu, mu_pad, k_last and every leaf's path, offset, size, role
    and k equal the reference's: conv0/* dense, fc/* top-k only (at the
    paper's widths n = 588,008, mu_pad 544 at alpha = 0.001 and 26,784
    at 0.05, k_last 52 at 0.001)."""
    rcfg, cfg = _configs(which)
    ours = SP.build_layout(CN.init_convnet5(torch.Generator(), cfg),
                           sparsity)
    ref = RSP.build_layout(_ref_params(which), sparsity)
    assert (ours.n_total, ours.mu, ours.mu_pad, ours.k_last) == \
        (ref.n_total, ref.mu, ref.mu_pad, ref.k_last)
    assert [dataclasses.astuple(a) for a in ours.leaves] == \
        [dataclasses.astuple(b) for b in ref.leaves]
    if which == "full":
        assert ours.n_total == 588008
        assert {0.001: (544, 52), 0.05: (26784, 2570)}.get(
            sparsity, (ours.mu_pad, ours.k_last)) == (ours.mu_pad,
                                                      ours.k_last)


@pytest.mark.parametrize("kind", ["correlated", "independent", "constant",
                                  "gradients"])
def test_gradient_information_matches_reference(kind):
    r = np.random.default_rng(len(kind))
    a = r.standard_normal(5000).astype(np.float32)
    if kind == "correlated":
        b = a + 0.3 * r.standard_normal(5000).astype(np.float32)
    elif kind == "independent":
        b = r.standard_normal(5000).astype(np.float32)
    elif kind == "constant":
        a = np.full(300, 0.25, np.float32)
        b = a.copy()
    else:                                  # two nodes' conv gradients
        b = (a * 1e-3 + r.laplace(size=5000) * 1e-4).astype(np.float32)
        a = a * 1e-3
    for bins in (16, 64, 256):
        assert dataclasses.astuple(IT.gradient_information(a, b, bins)) == \
            dataclasses.astuple(RIT.gradient_information(a, b, bins))
    assert dataclasses.astuple(IT.gradient_information(
        torch.from_numpy(a), torch.from_numpy(b))) == \
        dataclasses.astuple(RIT.gradient_information(a, b))


def test_information_plane_example_runs_on_cpu():
    """The example at its defaults on the CPU: a fraction in [0, 1] per
    layer at steps 0, 5, ..., 25; with the reference's weights, step 0's
    fractions within 0.02 of the reference example's computation (the
    same gradients to ~1e-6 can move a value across a bin edge)."""
    fracs = example.main(["--device", "cpu"])
    assert list(fracs) == [0, 5, 10, 15, 20, 25]
    assert all(len(row) == 5 and all(0.0 <= f <= 1.0 for f in row)
               for row in fracs.values())
    rcfg, cfg = _configs("smoke")
    rparams = _ref_params("smoke")
    ours = example.mi_fractions(params_from_numpy(rparams), cfg, steps=1)[0]
    batch = next(ref_images(rcfg.num_classes, 32, rcfg.image_size, seed=5))
    want = []
    grads = [jax.grad(lambda p, b: RCN.convnet5_loss(p, rcfg, b)[0])(
        rparams, {k: v[i * 16:(i + 1) * 16] for k, v in batch.items()})
        for i in range(2)]
    for i in range(5):
        want.append(RIT.gradient_information(
            np.asarray(grads[0][f"conv{i}"]["w"]).ravel(),
            np.asarray(grads[1][f"conv{i}"]["w"]).ravel(),
            bins=64).mi_fraction)
    np.testing.assert_allclose(ours, want, rtol=0, atol=0.02)


# -- the reference's ConvNet5 loop --------------------------------------------------


def _port_loop(rparams, rae, method, transport, topk, sparsity, seed):
    """The port's side: sim_sgd_step for STEPS steps from the reference's
    weights (and AE); yields (step, phase, metrics, g, states, params)."""
    _, cfg = _configs("smoke")
    cc = CompressionConfig(method=method, sparsity=sparsity, warmup_steps=2,
                           ae_train_steps=2, topk_backend=topk,
                           ae_backend="pallas", transport=transport)
    params = params_from_numpy(rparams)
    comp = build_compressor(cc, params, K)
    states = comp.init_sim_states(torch.Generator())
    if rae is not None:
        states["ae"] = ae_from_numpy(rae)
    data = synthetic_image_batches(cfg.num_classes, K * PER_NODE,
                                   cfg.image_size, seed=seed)

    def loss_fn(p, b):
        return CN.convnet5_loss(p, cfg, b)

    for step in range(STEPS):
        batch = {k: torch.from_numpy(x) for k, x in next(data).items()}
        params, states, g, metrics = sim_sgd_step(
            loss_fn, comp, params, states, batch, step, LR)
        yield step, metrics, g, states, params, comp


def _check_step(where, metrics, g, states, params, comp, ref):
    """One step against the reference's: loss to rtol 1e-5, the global
    gradient, u, v and the parameters to 2e-5 of their largest value,
    the sent support and the cleared coordinates bitwise, the wire rows
    the pricer's."""
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=1e-5, err_msg=where)
    np.testing.assert_allclose(float(metrics["accuracy"]), ref["acc"],
                               rtol=0, atol=1e-6, err_msg=where)
    _close(g.numpy(), ref["g"], 2e-5, where + " global gradient")
    if metrics["phase"] != "warmup":
        np.testing.assert_array_equal(g.numpy() != 0, ref["g"] != 0, where)
    for key in ("u", "v"):
        ours = states[key].numpy()
        np.testing.assert_array_equal(ours == 0, ref[key] == 0,
                                      f"{where} cleared {key}")
        _close(ours, ref[key], 2e-5, f"{where} {key}")
    _close(torch.cat([p.reshape(-1) for p in tree_leaves(params)]),
           ref["params"], 2e-5, where + " params")
    plan = XP.build_plan(comp.cc, comp.layout, K, phase=metrics["phase"])
    assert metrics["wire"] == XP.wire_terms_by_op(plan), where


def test_lgc_rar_loop_matches_reference():
    """lgc_rar at alpha = 0.05 (mu_pad 528 on the smoke config) through
    all three phases, K = 2, SGD at lr 0.08: the port's fused sweep and
    kernel encoder (their plain versions here) against the reference's
    jnp backends in its sim_step loop; the AE to 1e-12 of its largest
    value."""
    rcfg, _ = _configs("smoke")
    rparams = _ref_params("smoke")
    rcc = RCC(method="lgc_rar", sparsity=0.05, warmup_steps=2,
              ae_train_steps=2)
    rcomp = ref_build_compressor(rcc, rparams, K)
    rstates = rcomp.init_sim_states(jax.random.PRNGKey(1))
    rsim = jax.jit(rcomp.sim_step, static_argnums=(3,))

    @jax.jit
    def rnode_grads(p, batch):
        def one(i):
            lb = {k: jax.lax.dynamic_slice_in_dim(x, i * PER_NODE, PER_NODE)
                  for k, x in batch.items()}
            (l, m), g = jax.value_and_grad(RCN.convnet5_loss, has_aux=True)(
                p, rcfg, lb)
            return l, m["accuracy"], ref_flatten(g)
        ls, accs, gs = jax.vmap(one)(jnp.arange(K))
        return ls.mean(), accs.mean(), gs

    data = ref_images(rcfg.num_classes, K * PER_NODE, rcfg.image_size,
                      seed=0)
    rp = jax.tree_util.tree_map(jnp.asarray, rparams)
    phases = []
    for step, metrics, g, states, params, comp in _port_loop(
            rparams, _np(rstates["ae"]), "lgc_rar", "mesh", "fused", 0.05, 0):
        phase = ref_phase_for_step(step, rcc)
        assert metrics["phase"] == phase
        phases.append(phase)
        loss, acc, g_nodes = rnode_grads(rp, next(data))
        rg, rstates, _ = rsim(rstates, g_nodes, step, phase)
        rp = jax.tree_util.tree_map(lambda p, gl: p - LR * gl, rp,
                                    ref_unflatten(rg, rp))
        ref = {"loss": float(loss), "acc": float(acc), "g": np.asarray(rg),
               "u": np.asarray(rstates["u"]), "v": np.asarray(rstates["v"]),
               "params": np.asarray(ref_flatten(rp))}
        where = f"lgc_rar step {step} ({phase})"
        _check_step(where, metrics, g, states, params, comp, ref)
        _close(torch.cat([a.reshape(-1) for a in tree_leaves(states["ae"])]),
               ref_flatten(rstates["ae"]), 1e-12, where + " ae")
    assert phases == ["warmup"] * 2 + ["topk_ae"] * 2 + ["compressed"] * 2


REF_DGC = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs.base import CompressionConfig
from repro.configs.convnet5 import smoke_config
from repro.core import build_compressor
from repro.core.phases import phase_for_step
from repro.data import synthetic_image_batches
from repro.models.convnet import convnet5_loss, init_convnet5
from repro.utils.tree import tree_flatten_vector, tree_unflatten_vector

K, STEPS, PER_NODE, LR = {K}, {STEPS}, {PER_NODE}, {LR}
mesh = jax.make_mesh((K,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
cfg = smoke_config()
params = init_convnet5(jax.random.PRNGKey(0), cfg)
cc = CompressionConfig(method="dgc", sparsity=0.01, warmup_steps=2,
                       topk_backend="jnp", transport="ring_packed")
comp = build_compressor(cc, params, K)
st = comp.init_sim_states(jax.random.PRNGKey(1))
u, v = st["u"], st["v"]

@jax.jit
def node_grads(p, batch):
    def one(i):
        lb = {{k: jax.lax.dynamic_slice_in_dim(x, i * PER_NODE, PER_NODE)
              for k, x in batch.items()}}
        (l, m), g = jax.value_and_grad(convnet5_loss, has_aux=True)(
            p, cfg, lb)
        return l, m["accuracy"], tree_flatten_vector(g)
    ls, accs, gs = jax.vmap(one)(jnp.arange(K))
    return ls.mean(), accs.mean(), gs

def make(phase):
    def inner(u, v, g, step):
        gg, s2, _ = comp.dist_step({{"u": u[0], "v": v[0]}}, g[0], step,
                                   phase, ("data",), transport="ring_packed")
        return gg[None], s2["u"][None], s2["v"][None]
    return jax.jit(jax.shard_map(
        inner, mesh=mesh, in_specs=(P("data"),) * 3 + (P(),),
        out_specs=(P("data"),) * 3, axis_names={{"data"}},
        check_vma=False))

fns, out = {{}}, {{}}
data = synthetic_image_batches(cfg.num_classes, K * PER_NODE, cfg.image_size,
                               seed=1)
for step in range(STEPS):
    phase = phase_for_step(step, cc)
    loss, acc, g_nodes = node_grads(params, next(data))
    if phase not in fns:
        fns[phase] = make(phase)
    gg, u, v = fns[phase](u, v, g_nodes, jnp.int32(step))
    params = jax.tree_util.tree_map(lambda p, g: p - LR * g, params,
                                    tree_unflatten_vector(gg[0], params))
    key = str(step)
    out[key + "/loss"], out[key + "/acc"] = np.float64(loss), np.float64(acc)
    out[key + "/g"], out[key + "/u"] = np.asarray(gg[0]), np.asarray(u)
    out[key + "/v"] = np.asarray(v)
    out[key + "/params"] = np.asarray(tree_flatten_vector(params))
np.savez({path!r}, **out)
print("PASS")
"""


def test_dgc_ring_packed_loop_matches_reference(subproc, tmp_path):
    """dgc at alpha = 0.01 (k = 1 on every BN leaf) with the block top-k
    (K6's plain version here) on the packed ring, each node's pairs
    through the int8 + bit-plane codec (K4, K5b), 2 warm-up and 4
    sparsified steps at lr 0.08, against the reference's jnp top-k on its
    ring_packed dist_step: the same trajectory tolerances as the mesh
    loop, the int8 values included (the codec is bitwise)."""
    path = str(tmp_path / "dgc.npz")
    out = subproc(REF_DGC.format(K=K, STEPS=STEPS, PER_NODE=PER_NODE, LR=LR,
                                 path=path), devices=K)
    assert "PASS" in out
    ref = dict(np.load(path))
    phases = []
    for step, metrics, g, states, params, comp in _port_loop(
            _ref_params("smoke"), None, "dgc", "ring_packed", "pallas",
            0.01, 1):
        phases.append(metrics["phase"])
        r = {name: ref[f"{step}/{name}"] for name in
             ("loss", "acc", "g", "u", "v", "params")}
        _check_step(f"dgc ring_packed step {step} ({metrics['phase']})",
                    metrics, g, states, params, comp,
                    {**r, "loss": float(r["loss"]), "acc": float(r["acc"])})
    assert phases == ["warmup"] * 2 + ["topk_ae"] * 4
