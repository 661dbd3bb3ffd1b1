"""The port's sparsification against the JAX reference: the fused
accumulate + select (plain version on the CPU) bitwise — indices (ties,
all-zero leaves, mu_pad sentinels, unaligned leaf boundaries), u', v'
and values, the EF momentum being one FMA on both sides; the plain sweep
kernel's candidate triples against the Pallas kernel in interpret mode;
the jitted momentum correction; and the scatter/gather/clear helpers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as RSP
from repro.kernels import ops as ROPS
from repro_torch.core import sparsify as SP
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import segmented_topk as ST
from repro_torch.kernels import sparsify_ef as EF
from repro_torch.kernels.block_topk import block_topk

# odd sizes: no leaf boundary is a multiple of 128 or of the 1024 block
SHAPES = {"embed": {"w": (11, 3)},
          "block1": {"w": (57, 31), "b": (13,)},
          "block2": {"w": (41, 29)},
          "fc": {"w": (17, 19)}}


def _trees(sparsity):
    ref = {k: {n: jnp.zeros(s) for n, s in d.items()}
           for k, d in SHAPES.items()}
    ours = {k: {n: torch.zeros(s) for n, s in d.items()}
            for k, d in SHAPES.items()}
    return SP.build_layout(ours, sparsity), RSP.build_layout(ref, sparsity)


LAYOUT, RLAYOUT = _trees(0.05)
N = LAYOUT.n_total
ROLES = (SP.ROLE_COMPRESSED, SP.ROLE_TOPK_ONLY)


def _vec(kind, seed, n=N):
    r = np.random.default_rng(seed)
    if kind == "normal":
        return r.standard_normal(n).astype(np.float32)
    if kind == "ties":                     # nearly every magnitude tied
        return r.integers(-2, 3, n).astype(np.float32)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    x = np.zeros(n, np.float32)            # one live leaf element
    x[LAYOUT.compressed[1].offset + 5] = 3.0
    return x


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind,seed,m,momentum_on", [
    ("normal", 0, 0.9, True), ("normal", 1, 0.3, False),
    ("ties", 2, 0.9, True), ("ties", 3, 0.5, False),
    ("zeros", 4, 0.9, True), ("one_live", 5, 0.9, True)])
def test_fused_accumulate_select_matches_reference(kind, seed, m,
                                                   momentum_on):
    g, u, v = (_vec(kind, seed + 10 * i) for i in range(3))
    if kind == "one_live":
        u = v = np.zeros(N, np.float32)
    ours = SP.fused_accumulate_select(_t(g), _t(u), _t(v), LAYOUT, m,
                                      use_momentum=momentum_on)
    ref = RSP.fused_accumulate_select(jnp.asarray(g), jnp.asarray(u),
                                      jnp.asarray(v), RLAYOUT, m,
                                      use_momentum=momentum_on)
    u2, v2, vals, idx, lvals, lidx = (np.asarray(x) for x in ours)
    ru2, rv2, rvals, ridx, rlvals, rlidx = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(idx, ridx)           # bitwise, ties too
    np.testing.assert_array_equal(lidx, rlidx)
    for a, b in ((u2, ru2), (v2, rv2), (vals, rvals), (lvals, rlvals)):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    pad = idx >= N
    assert pad.sum() == LAYOUT.mu_pad - LAYOUT.mu > 0
    assert (vals[pad] == 0).all() and (idx[pad] == N).all()


@pytest.mark.parametrize("backend", ["jnp", "pallas", "fused"])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
def test_select_topk_matches_reference(backend, kind):
    v = _vec(kind, 7)
    for ours, ref in ((SP.select_topk, RSP.select_topk),
                      (SP.select_topk_last, RSP.select_topk_last)):
        vals, idx = ours(_t(v), LAYOUT, backend=backend)
        rvals, ridx = ref(jnp.asarray(v), RLAYOUT, backend=backend)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


@pytest.mark.parametrize("extract", ["loop", "bitonic"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_plain_sweep_triples_match_pallas_kernel(extract, kind):
    """The plain version of the CUDA sweep kernel against the reference's
    Pallas kernel (ops.fused_ef_topk, interpret mode), bitwise: candidate
    indices, slots and values, u' and v' (m*u + g one FMA on both
    sides)."""
    ex, block, seg, kcap, n_cand, _ = SP._fused_meta(LAYOUT, ROLES, extract)
    g, u, v = (_vec(kind, 20 + i) for i in range(3))
    ours = EF.sparsify_ef_topk_plain(_t(g), _t(u), _t(v), _t(seg),
                                     _t(kcap), 0.9, True, n_cand, block)
    ref = ROPS.fused_ef_topk(jnp.asarray(g), jnp.asarray(u), jnp.asarray(v),
                             jnp.asarray(seg), jnp.asarray(kcap), 0.9, True,
                             n_cand, block=block, extract=ex)
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b).reshape(-1)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b)


def test_clear_sent_merged_drops_sentinel():
    r = np.random.default_rng(3)
    u, v = (r.standard_normal(N).astype(np.float32) for _ in range(2))
    ia = r.integers(0, N + 1, 37).astype(np.int32)   # N = sentinel
    ib = np.concatenate([r.integers(0, N, 10), [N]]).astype(np.int32)
    ru, rv = RSP.clear_sent_merged(jnp.asarray(u), jnp.asarray(v),
                                   jnp.asarray(ia), jnp.asarray(ib), N)
    tu, tv = _t(u), _t(v)
    SP.clear_sent_merged(tu, tv, _t(ia), _t(ib), N)   # in place
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_scatter_gather_dense_segments_match_reference():
    r = np.random.default_rng(4)
    g = r.standard_normal(N).astype(np.float32)
    idx = np.concatenate([r.choice(N, 50, replace=False), [N, N]]
                         ).astype(np.int32)
    vals = r.standard_normal(52).astype(np.float32)
    np.testing.assert_array_equal(
        SP.scatter_to_dense(_t(vals), _t(idx), N).numpy(),
        np.asarray(RSP.scatter_to_dense(jnp.asarray(vals), jnp.asarray(idx),
                                        N)))
    np.testing.assert_array_equal(
        SP.gather_at(_t(g), _t(idx)).numpy(),
        np.asarray(RSP.gather_at(jnp.asarray(g), jnp.asarray(idx))))
    seg = SP.dense_segments(_t(g), LAYOUT)
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(RSP.dense_segments(jnp.asarray(g), RLAYOUT)))
    np.testing.assert_array_equal(
        SP.scatter_dense_segments(seg, LAYOUT, N).numpy(),
        np.asarray(RSP.scatter_dense_segments(jnp.asarray(seg.numpy()),
                                              RLAYOUT, N)))


def test_momentum_correct_matches_reference():
    """Bitwise against the reference as it runs, under jit, where XLA
    contracts m*u + g into one FMA (the eager reference does not)."""
    r = np.random.default_rng(5)
    u, v, g = (r.standard_normal(N).astype(np.float32) for _ in range(3))
    ref = jax.jit(RSP.momentum_correct, static_argnums=3)(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(g), 0.9)
    for a, b in zip(SP.momentum_correct(_t(u), _t(v), _t(g), 0.9), ref):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))


def test_cuda_tensor_launches_or_raises():
    """For a tensor that is not on the CPU a wrapper never takes the
    plain version: on a machine with no card, a meta tensor is refused by
    the fused sweep (K1), the segmented sweep (K2) and the block top-k
    (K6), and by the selections that reach them."""
    ex, block, seg, kcap, n_cand, _ = SP._fused_meta(LAYOUT, ROLES, "loop")
    g = torch.zeros(N, device="meta")
    seg_m, kcap_m = _t(seg).to("meta"), _t(kcap).to("meta")
    with pytest.raises(ValueError):
        EF.sparsify_ef_topk(g, g, g, seg_m, kcap_m, 0.9, True, n_cand, block)
    with pytest.raises(ValueError):
        ST.segmented_topk(g, seg_m, kcap_m, n_cand, block,
                          active=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        block_topk(torch.zeros((2, 256), device="meta"), 8)
    with pytest.raises(ValueError):
        OPS.global_topk(g, 5, block=256)
    for backend in ("pallas", "fused"):
        with pytest.raises(ValueError):
            SP.select_topk(g, LAYOUT, backend=backend)
