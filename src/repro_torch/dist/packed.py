"""The packed sparse wire: its plan and its codec (counterpart of
``repro.dist.packed``).

A :class:`PackPlan` fixes, per (n, k, scale_block), the wire format of k
(value, index) pairs over a length-n vector: the sorted indices' high bits
as a bucket histogram, their low ``lo_bits`` bits bit-plane packed, the
values as int8 with one f32 scale per ``scale_block`` (or, for a handful
of indices, the sorted raw int32 indices).  :func:`make_plan` picks
``lo_bits`` by exact cost minimisation; :func:`wire_nbytes` and
:func:`index_nbytes` are what the pricers charge.  The exchange plan
carries one PackPlan per packed sparse exchange.

The codec builds and reads the payload the packed ring transport ships:
:func:`encode_sparse_fused` sorts a node's pairs by index, histograms the
high bits and runs K4 (``kernels.bitpack.quantize_pack``: int8 values and
the low-bit planes in one launch); :func:`decode_sparse` unpacks the
planes with K5b and re-expands the histogram, one launch for a whole
gathered table; :func:`encode_indices` /
:func:`decode_indices` carry an index set alone (K5a / K5b), bit-exact.
A plan with ``checksum`` appends the guard's integrity word
(:func:`checksum_word`) to every payload, and :func:`validate_payload` is
the guard's structural check of a received one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import chaos as CH
from repro_torch.dist import quantize as Q
from repro_torch.kernels import bitpack as BP
from repro_torch.kernels.bitpack import bit_width, packed_nbytes

# the compressor methods whose sparse exchanges ride the packed wire (real
# bytes on the packed ring transport, the exact f32 + int32 wire elsewhere)
PACKED_METHODS = ("sparse_gd", "dgc", "lgc_ps")

@dataclass(frozen=True)
class PackPlan:
    """Static wire-format parameters for a (n, k, scale_block) exchange."""
    n: int                  # dense length; indices live in [0, n]
    k: int                  # pairs per node (sentinel padding included)
    width: int              # bit_width(n): total index bits
    lo_bits: int            # bits packed through the bit-plane kernel
    n_buckets: int          # high-bits histogram length
    scale_block: int        # values per f32 scale (shared with quantize)
    raw_index: bool = False  # small-k fallback: sorted raw int32 indices
    checksum: bool = False   # guard option: one trailing int32 sum word

    @property
    def hi_bits(self) -> int:
        return self.width - self.lo_bits


def _index_nbytes(n: int, k: int, lo_bits: int) -> int:
    n_buckets = (n >> lo_bits) + 1
    return 4 * n_buckets + packed_nbytes(k, lo_bits)


def make_plan(n: int, k: int, scale_block: int = 0,
              checksum: bool = False) -> PackPlan:
    """Pick ``lo_bits`` minimising the exact index payload (4·n_buckets +
    packed_nbytes(k, lo_bits)); fall back to raw sorted int32 indices
    where even the best split costs more (k of a handful).  ``checksum``
    adds one int32 word to the payload."""
    assert n >= 1 and k >= 1, (n, k)
    width = bit_width(n)
    best = min(range(1, width + 1),
               key=lambda lo: _index_nbytes(n, k, lo))
    return PackPlan(n=n, k=k, width=width, lo_bits=best,
                    n_buckets=(n >> best) + 1,
                    scale_block=scale_block or Q.SCALE_BLOCK,
                    raw_index=4 * k < _index_nbytes(n, k, best),
                    checksum=checksum)


def bucket_plan(plan: PackPlan, kb: int) -> PackPlan:
    """The per-bucket sub-plan of a bucketed packed exchange: ``kb`` pairs
    per bucket, every other parameter inherited from ``plan``."""
    assert 1 <= kb <= plan.k, (kb, plan.k)
    assert not plan.raw_index, plan
    return PackPlan(n=plan.n, k=kb, width=plan.width,
                    lo_bits=plan.lo_bits, n_buckets=plan.n_buckets,
                    scale_block=plan.scale_block, raw_index=False,
                    checksum=plan.checksum)


def _index_base(plan: PackPlan) -> int:
    # the index half without the optional checksum word
    if plan.raw_index:
        return 4 * plan.k
    return _index_nbytes(plan.n, plan.k, plan.lo_bits)


def index_nbytes(plan: PackPlan) -> int:
    """Wire bytes of the index-only payload (counts + packed low-bit
    planes, or the raw indices), plus the checksum word if any."""
    return _index_base(plan) + (4 if plan.checksum else 0)


def wire_nbytes(plan: PackPlan) -> int:
    """Total payload bytes one node ships per packed sparse exchange:
    indices, int8 values with their scales, and the checksum word if
    any."""
    return _index_base(plan) + Q.wire_nbytes(plan.k, plan.scale_block) \
        + (4 if plan.checksum else 0)


# -- the codec ----------------------------------------------------------------


def _sort_pairs(vals: torch.Tensor, idx: torch.Tensor):
    """Pairs in ascending index order; stable, as jnp.argsort is (only
    the sentinel n can repeat)."""
    order = torch.argsort(idx, stable=True)
    return vals[order], idx[order].to(torch.int32)


def _lo_mask(plan: PackPlan) -> int:
    return (1 << plan.lo_bits) - 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 ``x`` taken mod 2^32 into int32's range: what the reference's
    int32 sums give."""
    x = x & 0xFFFFFFFF
    return x - ((x >> 31) << 32)


def _histogram(idx: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """Counts of the high bits idx >> lo_bits over the plan's buckets."""
    counts = torch.zeros((plan.n_buckets,), dtype=torch.int32,
                         device=idx.device)
    return counts.index_add_(0, (idx >> plan.lo_bits).long(),
                             torch.ones_like(idx))


def _expand_hi(counts: torch.Tensor, k: int) -> torch.Tensor:
    """(..., n_buckets) counts -> (..., k) int32 bucket ids: bucket b
    repeated counts[b] times, cut or filled (with the last bucket that
    started) to k.  This is ``jnp.repeat(arange, counts,
    total_repeat_length=k)`` step for step (a mark at each bucket's int32
    start, a start in [-k, 0) counted from the end and any other outside
    [0, k) dropped, then a running count of marks), so it decodes a
    corrupted histogram as the reference does."""
    starts = _wrap32(F.pad(counts[..., :-1].to(torch.int64), (1, 0))
                     .cumsum(-1))
    starts = torch.where(starts < 0, starts + k, starts)
    starts = torch.where((starts >= 0) & (starts < k), starts, k)
    marks = torch.zeros(counts.shape[:-1] + (k + 1,), dtype=torch.int32,
                        device=counts.device)
    marks.scatter_add_(-1, starts, torch.ones_like(starts,
                                                   dtype=torch.int32))
    return marks[..., :k].cumsum(-1, dtype=torch.int32) - 1


def checksum_word(payload) -> torch.Tensor:
    """The guard's integrity word over a payload tuple: the int32 sum,
    wrapping mod 2^32, of every array viewed as int32 (int8 widened, f32
    by its bits).  Shape (1,); on a gathered (B, ...) table, (B, 1), one
    word per payload."""
    lead = payload[0].dim() - 1
    total = 0
    for a in payload:
        w = a.to(torch.float32).view(torch.int32) if a.is_floating_point() \
            else a
        total = total + w.to(torch.int64).flatten(lead).sum(-1)
    return _wrap32(total).to(torch.int32).unsqueeze(-1)


def _with_checksum(payload: Tuple[torch.Tensor, ...], plan: PackPlan):
    return payload + (checksum_word(payload),) if plan.checksum else payload


def _encode_indices_body(idx: torch.Tensor, plan: PackPlan):
    assert idx.shape == (plan.k,), (idx.shape, plan)
    idx = idx.to(torch.int32)
    if plan.raw_index:
        return (idx,)
    return (_histogram(idx, plan),
            BP.pack_bits(idx & _lo_mask(plan), plan.lo_bits))


def _decode_indices_body(payload, plan: PackPlan) -> torch.Tensor:
    if plan.raw_index:
        (idx,) = payload
        return idx
    counts, words = payload
    lo = BP.unpack_bits(words, plan.k)
    return (_expand_hi(counts, plan.k) << plan.lo_bits) | lo


def encode_indices(idx: torch.Tensor, plan: PackPlan
                   ) -> Tuple[torch.Tensor, ...]:
    """A sorted-ascending int32 index set (plan.k,) over [0, n] ->
    (counts, words), or (idx,) on the raw-index fallback, and the checksum
    word last when the plan has one."""
    return _with_checksum(_encode_indices_body(idx, plan), plan)


def decode_indices(payload, plan: PackPlan) -> torch.Tensor:
    """Inverse of :func:`encode_indices` -> sorted int32 (plan.k,); on a
    gathered (B, ...) table of payloads -> (B, plan.k), one K5b launch
    for all B.  The checksum word is dropped, not checked
    (:func:`validate_payload` checks it)."""
    if plan.checksum:
        payload = payload[:-1]
    return _decode_indices_body(payload, plan)


def encode_sparse(vals: torch.Tensor, idx: torch.Tensor, plan: PackPlan):
    """The composed encode: (counts, words, q, scales), or (idx, q,
    scales) on the raw-index fallback, and the checksum word last when
    the plan has one.  The quantizer reports its non-finite count to an
    open guard sink."""
    assert vals.shape == idx.shape == (plan.k,), (vals.shape, plan)
    vals_s, idx_s = _sort_pairs(vals, idx)
    q, scales = Q.quantize_i8(vals_s, plan.scale_block)
    return _with_checksum(_encode_indices_body(idx_s, plan) + (q, scales),
                          plan)


def encode_sparse_fused(vals: torch.Tensor, idx: torch.Tensor,
                        plan: PackPlan):
    """:func:`encode_sparse` with the quantize and the low-bit pack in
    one launch of K4; the same payload bit for bit.  It takes the
    composed path, as the reference does, where the plan has nothing to
    pack (raw indices).  K4 zeroes non-finite values without counting
    them, so under an open guard sink their count is reported beside it:
    the quantizer's count, as its zero padding is finite."""
    if plan.raw_index:
        return encode_sparse(vals, idx, plan)
    assert vals.shape == idx.shape == (plan.k,), (vals.shape, plan)
    vals_s, idx_s = _sort_pairs(vals, idx)
    if CH.structural_sink_active():
        CH.report_structural((~torch.isfinite(vals_s)).sum())
    words, q, scales = Q.quantize_pack_fused(
        vals_s, idx_s & _lo_mask(plan), plan.lo_bits, plan.scale_block)
    return _with_checksum((_histogram(idx_s, plan), words, q, scales), plan)


def decode_sparse(payload, plan: PackPlan):
    """Inverse of :func:`encode_sparse` -> (vals f32 (k,), idx int32
    (k,)) in index order: indices bit-exact, values dequantized.  On a
    gathered (B, ...) table, (B, k) each, with one K5b launch.  The
    checksum word is dropped, not checked."""
    if plan.checksum:
        payload = payload[:-1]
    q, scales = payload[-2], payload[-1]
    idx = _decode_indices_body(payload[:-2], plan)
    return Q.dequantize_i8(q, scales, plan.k), idx


def validate_payload(payload, plan: PackPlan, values: bool = True,
                     idx: Optional[torch.Tensor] = None):
    """The guard's structural checks of a received payload, or of each
    payload of a gathered (B, ...) table: the checksum word equals a
    recompute (when the plan has one), the histogram is non-negative and
    sums to k, the value scales are finite (``values`` payloads), and the
    decoded indices lie in [0, n] and do not decrease.  ``idx`` is the
    payload's decode where the caller has it (the gathered table's one K5b
    launch), else it is decoded here.  Returns (ok, bad): bool and the
    count of failed checks, scalars or (B,)."""
    checks = []
    body = payload
    if plan.checksum:
        body, chk = payload[:-1], payload[-1]
        checks.append((checksum_word(body) == chk).all(-1))
    ipay = body[:-2] if values else body
    if not plan.raw_index:
        counts = ipay[0]
        checks.append((counts >= 0).all(-1))
        checks.append(_wrap32(counts.to(torch.int64).sum(-1)) == plan.k)
    if values:
        checks.append(torch.isfinite(body[-1]).all(-1))
    if idx is None:
        idx = _decode_indices_body(ipay, plan)
    checks.append(((idx >= 0) & (idx <= plan.n)).all(-1))
    if plan.k > 1:
        checks.append((idx[..., 1:] >= idx[..., :-1]).all(-1))
    bad = sum((~c).to(torch.int64) for c in checks)
    return bad == 0, bad


def fake_roundtrip(vals: torch.Tensor, idx: torch.Tensor,
                   scale_block: int = 0):
    """encode -> decode in the float domain: the pairs sorted by index,
    the sorted values quantized and dequantized in the wire's blocks."""
    vals_s, idx_s = _sort_pairs(vals, idx)
    return Q.fake_quantize(vals_s, scale_block or Q.SCALE_BLOCK), idx_s
