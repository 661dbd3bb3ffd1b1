"""The port's selection order on NaN, ±inf, ±0 and subnormals against the
reference's ``jnp`` backend (``lax.top_k``), bitwise.

The port orders every selection by the bits of |x| with the sign cleared
(NaN above inf, a NaN's payload deciding among NaNs, ties lowest index
first): ``select_topk`` and ``select_topk_last`` with ``backend="pallas"``
(K6's plain version) and ``backend="fused"`` (K2's), and
``fused_accumulate_select`` (K1's).  On the CPU these run the plain
versions that the card's kernels are held to bitwise.  The reference's
Pallas block top-k and its ``loop`` extractor order NaN otherwise; the
port follows its ``jnp`` backend, which is what is pinned here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as RSP
from repro_torch.core import sparsify as SP

# odd leaf sizes, several slot pieces per sweep block, a dense leaf
# between them and a top-k-only last layer
SHAPES = {"embed": {"w": (23, 5)},
          "block1": {"w": (61, 19), "b": (13,)},
          "block2": {"w": (37, 29)},
          "fc": {"w": (17, 11)}}

# NaNs of several payloads and signs (a signalling one too), ±inf, ±0.0,
# subnormals (the smallest, a middle one, the largest)
SPECIAL_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7FC00001, 0xFFFFFFFF,
                         0x7F800001, 0x7F800000, 0xFF800000, 0x00000000,
                         0x80000000, 0x00000001, 0x80000001, 0x00012345,
                         0x807FFFFF], dtype=np.uint32)


def _layouts(sparsity):
    ref = {k: {n: jnp.zeros(s) for n, s in d.items()}
           for k, d in SHAPES.items()}
    ours = {k: {n: torch.zeros(s) for n, s in d.items()}
            for k, d in SHAPES.items()}
    return SP.build_layout(ours, sparsity), RSP.build_layout(ref, sparsity)


def _special(n, frac, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal(n).astype(np.float32)
    at = r.random(n) < frac
    x[at] = SPECIAL_BITS[r.integers(0, len(SPECIAL_BITS), int(at.sum()))
                         ].view(np.float32)
    return x


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _assert_same(ours, ref):
    """(values, indices) pairs: values as bits, indices exactly."""
    for (v, i), (rv, ri) in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))
        np.testing.assert_array_equal(_bits(v), _bits(rv))


# all special: NaN (5/13 of the values), then inf (2/13), subnormals
# (4/13) and zeros (2/13), so k = 0.45 of a leaf cuts through the infs,
# 0.7 through the subnormals and 0.9 through the signed zeros; a third
# special at k = 0.3 cuts through the normal values
@pytest.mark.parametrize("frac,sparsity", [(1.0, 0.45), (1.0, 0.7),
                                           (1.0, 0.9), (0.3, 0.3)])
def test_selections_order_special_values_as_the_jnp_backend(frac,
                                                            sparsity):
    layout, rlayout = _layouts(sparsity)
    x = _special(layout.n_total, frac, int(100 * sparsity))
    ref = [(RSP.select_topk(jnp.asarray(x), rlayout, backend="jnp")),
           (RSP.select_topk_last(jnp.asarray(x), rlayout, backend="jnp"))]
    for backend in ("pallas", "fused"):
        ours = [SP.select_topk(torch.from_numpy(x), layout, backend=backend),
                SP.select_topk_last(torch.from_numpy(x), layout,
                                    backend=backend)]
        _assert_same(ours, ref)
    # the fused sweep with the accumulate: g = u = -0.0 leaves v' = v + -0
    # equal to v, NaN payloads and signed zeros included (a signalling NaN
    # comes out quiet), so its selection must be the jnp backend's on v'
    zero = torch.full((layout.n_total,), -0.0)
    for use_momentum in (True, False):
        u2, v2, vals, idx, lvals, lidx = SP.fused_accumulate_select(
            zero, zero, torch.from_numpy(x), layout, 0.9,
            use_momentum=use_momentum)
        v2 = v2.numpy()
        quiet = np.isnan(x) & ((_bits(x) & 0x00400000) == 0)
        np.testing.assert_array_equal(
            _bits(v2), np.where(quiet, _bits(x) | 0x00400000, _bits(x)))
        want = [RSP.select_topk(jnp.asarray(v2), rlayout, backend="jnp"),
                RSP.select_topk_last(jnp.asarray(v2), rlayout,
                                     backend="jnp")]
        _assert_same([(vals, idx), (lvals, lidx)], want)
