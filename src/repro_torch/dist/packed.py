"""The packed sparse wire's plan half (counterpart of the pure integer
arithmetic of ``repro.dist.packed``, with the byte counts of
``repro.kernels.bitpack`` and ``repro.dist.quantize`` it needs).

A :class:`PackPlan` fixes, per (n, k, scale_block), the wire format of k
(value, index) pairs over a length-n vector: the sorted indices' high bits
as a bucket histogram, their low ``lo_bits`` bits bit-plane packed, the
values as int8 with one f32 scale per ``scale_block`` (or, for a handful
of indices, the sorted raw int32 indices).  :func:`make_plan` picks
``lo_bits`` by exact cost minimisation; :func:`wire_nbytes` and
:func:`index_nbytes` are what the pricers charge.  The exchange plan
carries one PackPlan per packed sparse exchange.  The codec that builds
the payload (and its kernels K4, K5a, K5b) belongs to the packed-wire
transport, which is not ported yet (ROADMAP.md Queue 1, "multi-process
NCCL transports").
"""
from __future__ import annotations

from dataclasses import dataclass

# the compressor methods whose sparse exchanges ride the packed wire (real
# bytes on the packed ring transport, the exact f32 + int32 wire elsewhere)
PACKED_METHODS = ("sparse_gd", "dgc", "lgc_ps")

SCALE_BLOCK = 256     # int8-wire values per f32 scale (repro.dist.quantize)
GROUP = 32            # values packed into one int32 word (one per bit row)
MAX_WIDTH = 31        # value bits; bit 31 is the int32 sign


def bit_width(n: int) -> int:
    """Bits needed to represent any value in ``[0, n]``, inclusive: index
    sets are padded with the sentinel ``n``, which must survive the
    wire."""
    w = max(1, int(n).bit_length())
    assert w <= MAX_WIDTH, (n, w)
    return w


def word_count(k: int) -> int:
    """int32 words per bit-plane for ``k`` values: exactly ceil(k/32)."""
    return -(-max(int(k), 1) // GROUP)


def packed_nbytes(k: int, width: int) -> int:
    """Wire bytes of ``k`` values packed at ``width`` bits: the (width,
    word_count(k)) int32 array."""
    return width * word_count(k) * 4


def q8_wire_nbytes(n: int, scale_block: int = SCALE_BLOCK) -> int:
    """Wire bytes of ``n`` values on the int8 wire: the padded int8
    payload + one f32 scale per block (``repro.dist.quantize.wire_nbytes``)."""
    m = -(-n // scale_block)
    return m * scale_block * 1 + m * 4


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
                    scale_block=scale_block or SCALE_BLOCK,
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
    return _index_base(plan) + q8_wire_nbytes(plan.k, plan.scale_block) \
        + (4 if plan.checksum else 0)
