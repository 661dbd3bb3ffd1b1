"""The port's per-block top-k (K6's plain version), its global merge, and
the segmented sweep without the EF accumulate (K2's plain version) against
the JAX reference: the Pallas kernels in interpret mode and their jnp
oracles, bitwise — values, indices and tie order — on normal, tied and
all-zero data, blocks that are not powers of two, and lengths that need
padding; then ``select_topk(backend="pallas")`` on the smoke llama
layout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import sparsify as RSP
from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro.kernels.block_topk import block_topk as ref_block_topk
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.core import sparsify as SP
from repro_torch.kernels import ops
from repro_torch.kernels.block_topk import block_topk, block_topk_plain
from repro_torch.models.model import build_model


def _data(kind, shape, seed):
    r = np.random.default_rng(seed)
    if kind == "normal":
        x = r.standard_normal(shape)
    elif kind == "ties":                       # nearly every magnitude tied
        x = r.integers(-2, 3, shape)
    else:
        x = np.zeros(shape)
    return x.astype(np.float32)


def _eq(ours, ref):
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("block", [256, 384, 640])
@pytest.mark.parametrize("kb", ["part", "whole"])
def test_block_topk_plain_matches_reference(kind, block, kb):
    """Against the jnp oracle always, and against the Pallas kernel in
    interpret mode where kb <= 64."""
    x = _data(kind, (3, block), block)
    k = 37 if kb == "part" else block
    ours = block_topk(torch.from_numpy(x), k)          # CPU: the plain one
    _eq(ours, RREF.block_topk_ref(jnp.asarray(x), k))
    _eq(block_topk_plain(torch.from_numpy(x), k), ours)
    if k <= 64:
        _eq(ours, ref_block_topk(jnp.asarray(x), k))


# NaNs of several payloads and signs, +-inf, +-0.0, subnormals: the order
# by bits that K6 and the plain version share on every device
SPECIAL_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,
                         0x7F800000, 0xFF800000, 0x00000000, 0x80000000,
                         0x00000001, 0x80000001, 0x00012345, 0x807FFFFF],
                        dtype=np.uint32)


@pytest.mark.parametrize("kb", [1, 100, 384])
def test_block_topk_plain_orders_special_values_by_their_bits(kb):
    """|x| is the bits with the sign cleared, NaNs by payload above inf,
    ties lowest index first: against a numpy stable sort; values carry
    x's bits unchanged."""
    r = np.random.default_rng(kb)
    x = r.standard_normal((3, 384)).astype(np.float32)
    at = r.random(x.shape) < 0.5
    x[at] = SPECIAL_BITS[r.integers(0, len(SPECIAL_BITS), int(at.sum()))
                         ].view(np.float32)
    vals, idx = block_topk_plain(torch.from_numpy(x), kb)
    mag = x.view(np.uint32) & 0x7FFFFFFF
    want = np.argsort(-mag.astype(np.int64), axis=1, kind="stable")[:, :kb]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  np.take_along_axis(x, want, 1)
                                  .view(np.uint32))


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("n,k,block", [(1000, 37, 256), (1024, 64, 256),
                                       (777, 50, 384), (300, 16, 640)])
def test_global_topk_matches_reference(kind, n, k, block):
    """Zero padding (all but 1024/256 need it), the block kernel and the
    masked merge: bitwise the reference's global_topk (interpret mode)
    and the per-leaf jnp top-k."""
    x = _data(kind, (n,), n + k)
    vals, idx = ops.global_topk(torch.from_numpy(x), k, block=block)
    rv, ri = ROPS.global_topk(jnp.asarray(x), k, block=block)
    _eq((vals, idx), (rv, ri))
    assert idx.dtype == torch.int32
    lv, li = SP._leaf_topk(torch.from_numpy(x), k, 0)
    assert torch.equal(vals, lv) and torch.equal(idx.long(), li)


@pytest.mark.parametrize("extract", ["loop", "bitonic"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_segmented_topk_plain_matches_reference(extract, kind):
    """K2's plain version through ops.segmented_topk against the
    reference's (interpret mode): candidate triples bitwise, on a ragged
    length with several slot pieces per block and unselectable runs."""
    n, block = 2900, 1024
    seg = np.full((n,), -1, np.int32)
    bounds = [(0, 700, 0), (700, 1500, 1), (1700, 2600, 2), (2600, 2900, 3)]
    for lo, hi, s in bounds:
        seg[lo:hi] = s
    kcap = np.asarray([40, 9, 64, 3], np.int32)
    n_cand = 150
    x = _data(kind, (n,), 11)
    ours = ops.segmented_topk(torch.from_numpy(x), torch.from_numpy(seg),
                              torch.from_numpy(kcap), n_cand, block=block,
                              extract=extract)
    ref = ROPS.segmented_topk(jnp.asarray(x), jnp.asarray(seg),
                              jnp.asarray(kcap), n_cand, block=block,
                              extract=extract)
    _eq(ours, ref)


def _smoke_layouts():
    ours = SP.build_layout(build_model(get_arch("llama3.2-1b").reduced())
                           .init(torch.Generator(), "meta"), 0.001)
    ref = RSP.build_layout(jax.eval_shape(
        RefModel(ref_get_arch("llama3.2-1b").reduced()).init,
        jax.random.PRNGKey(0)), 0.001)
    return ours, ref


def test_select_topk_pallas_on_the_smoke_layout_matches_reference():
    """select_topk through K6's plain version (one call per leaf, the
    per-leaf block rule) against the reference's pallas backend in
    interpret mode, on the llama3.2-1b smoke layout: values and indices
    bitwise.  (The fused backend is held against the reference in
    test_torch_sparsify.py.)"""
    layout, rlayout = _smoke_layouts()
    v = _data("normal", (layout.n_total,), 5)
    ours = SP.select_topk(torch.from_numpy(v), layout, backend="pallas")
    ref = RSP.select_topk(jnp.asarray(v), rlayout, backend="pallas",
                          interpret=True)
    _eq(ours, ref)
