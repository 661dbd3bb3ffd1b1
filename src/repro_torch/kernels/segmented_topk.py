"""Per-block segmented candidate extraction (kernel K2).

:func:`select_candidates` is the counterpart of
``repro.kernels.segmented_topk.select_candidates`` (the "loop" extractor)
and ``repro.kernels.bitonic.select_candidates_bitonic`` (the "bitonic"
one): the reference proves the two bit-identical, so one plain version
serves both.  It runs vectorised over all blocks with two sorts on unique
int64 keys, which reproduce ``lax.top_k``'s order (|value| descending,
lowest index first) exactly, and is the plain version of both sweep
kernels: this module's :func:`segmented_topk` (``csrc/segmented_topk.cu``,
the reference's ``segmented_topk``) and the fused EF sweep
(``sparsify_ef``).  :func:`segmented_topk` launches the CUDA kernel for
tensors on the card and runs :func:`segmented_topk_plain` for tensors on
the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, build

LANE = 128
BLOCK = 8 * LANE          # default sweep block (one (8, 128) TPU tile)
LOC_BITS = 17             # local index bits: blocks are <= 2^17 elements
_MAG_MAX = 0x7FFFFFFF
# the sweep keeps one int counter per slot in dynamic shared memory beside
# the radix sort's 150 KB; 11Ki slots (44 KB) keep a CTA within the 227 KB
# it may have
_MAX_SLOTS = 11 * 1024


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def magnitude_rank(x: torch.Tensor) -> torch.Tensor:
    """int64 key ascending in |x| descending: 0x7FFFFFFF - bits(|x|), the
    sign bit cleared on the bits themselves, as the kernels do, so a NaN
    ranks by its payload on every device (torch.abs need not keep a NaN's
    bits on the card)."""
    return _MAG_MAX - (x.view(torch.int32) & _MAG_MAX).to(torch.int64)


def select_candidates(x: torch.Tensor, seg: torch.Tensor,
                      kcap: torch.Tensor, n_cand: int):
    """x, seg: (n_blocks, block) f32 / int32 (seg < 0 = not selectable);
    kcap: (n_slots,) int32.  Per block, for every slot piece its
    top-min(kcap, |piece|) elements, all emitted by |x| descending then
    index ascending.  Returns (vals, idx block-local, seg) each
    (n_blocks, n_cand); unused entries are (0, block, -1).  Runs in
    chunks of blocks so its int64 temporaries stay ~1 GiB at any n."""
    nb, block = x.shape
    assert block <= 1 << LOC_BITS and kcap.numel() < 1 << 14
    rows = max(1, (1 << 24) // block)
    parts = [_select(xc, sc, kcap, n_cand)
             for xc, sc in zip(x.split(rows), seg.split(rows))]
    return tuple(torch.cat(p) for p in zip(*parts))


def _select(x, seg, kcap, n_cand):
    nb, block = x.shape
    loc = torch.arange(block, device=x.device, dtype=torch.int64)
    mag = magnitude_rank(x) << LOC_BITS | loc
    # sort 1: grouped by slot, each group in selection order -> rank in slot
    by_slot = torch.sort((seg.to(torch.int64) + 1) << 48 | mag, dim=1)[0]
    pos = loc.expand(nb, block)
    slot = (by_slot >> 48) - 1
    starts = torch.ones_like(slot, dtype=torch.bool)
    starts[:, 1:] = slot[:, 1:] != slot[:, :-1]
    first = torch.cummax(torch.where(starts, pos, 0), dim=1)[0]
    kcap64 = kcap.to(torch.int64)
    cap = torch.where(slot >= 0, kcap64[slot.clamp(min=0)], 0)
    keep = (slot >= 0) & (pos - first < cap)
    # sort 2: the kept elements in selection order, the rest after them
    masked = torch.iinfo(torch.int64).max
    out = torch.sort(torch.where(keep, by_slot & ((1 << 48) - 1), masked),
                     dim=1)[0][:, :n_cand]
    live = out != masked
    li = torch.where(live, out & ((1 << LOC_BITS) - 1), 0)
    vals = torch.where(live, x.gather(1, li), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    idx = torch.where(live, li, block).to(torch.int32)
    segs = torch.where(live, seg.gather(1, li), -1).to(torch.int32)
    return vals, idx, segs


def active_blocks(seg: torch.Tensor, block: int) -> torch.Tensor:
    """(n_blocks,) int32: each block's row in the sweep kernels' sort
    scratch, or -1 for a block with no selectable element (seg < 0
    throughout)."""
    n = seg.shape[0]
    full = n // block
    has = seg[:full * block].view(full, block).amax(1) >= 0
    if n > full * block:
        has = torch.cat([has, (seg[full * block:].amax() >= 0)[None]])
    return torch.where(has, torch.cumsum(has, 0) - 1, -1).to(torch.int32)


def radix_scratch(active: torch.Tensor, block: int):
    """The sweep kernels' sort scratch, one row of ``block`` per active
    block: a 64-bit and a 32-bit word per element (the radix passes
    ping-pong between them, as the block top-k's do)."""
    rows = int(active.max()) + 1
    return (torch.empty((rows * block,), dtype=torch.int64,
                        device=active.device),
            torch.empty((rows * block,), dtype=torch.int32,
                        device=active.device))


def check_sweep(name: str, floats, seg, kcap, n_cand: int, block: int):
    """Refuse what the sweep kernels do not take: ``floats`` f32 and
    ``seg``, ``kcap`` int32, all contiguous on one CUDA device, the
    vectors (n,); 256 <= block <= 2^17, block % 128 == 0."""
    x = floats[0]
    n = x.shape[0]
    for t, dt in [(f, torch.float32) for f in floats] + [
            (seg, torch.int32), (kcap, torch.int32)]:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: f32 vectors and int32 seg, kcap, "
                             "contiguous, on one CUDA device")
    if x.device.type != "cuda" or any(t.shape != (n,)
                                      for t in list(floats) + [seg]):
        raise ValueError(f"{name}: the vectors and seg must be (n,) on the "
                         "card")
    nb = -(-n // block)
    if not (256 <= block <= 1 << LOC_BITS and block % 128 == 0) \
            or nb * block >= 2 ** 31 or not 0 < n_cand <= block \
            or not 0 < kcap.numel() <= _MAX_SLOTS:
        raise ValueError(f"{name}: unsupported block={block}, n={n}, "
                         f"n_cand={n_cand}, slots={kcap.numel()}")


def segmented_topk_plain(x, seg, kcap, n_cand: int, block: int):
    """The plain version of :func:`segmented_topk`: :func:`select_candidates`
    over the zero-padded blocks (seg padded with -1)."""
    n = x.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    vals, idx, segs = select_candidates(
        F.pad(x, (0, pad)).view(nb, block),
        F.pad(seg, (0, pad), value=-1).view(nb, block), kcap, n_cand)
    base = torch.arange(nb, device=x.device, dtype=torch.int32) * block
    return (vals.reshape(-1), (idx + base[:, None]).reshape(-1),
            segs.reshape(-1))


def segmented_topk(x, seg, kcap, n_cand: int, block: int, active=None):
    """x: (n,) f32; seg: (n,) int32 slot per element (-1 = not
    selectable); kcap: (n_slots,) int32.  Per block of ``block``
    elements, every slot piece's top-min(kcap, |piece|) elements as
    (value, global index, slot) triples, (n_blocks * n_cand,) each,
    unused entries (0, block end, -1).  ``active`` is
    :func:`active_blocks` (computed here when not given).  Same outputs
    as :func:`segmented_topk_plain`, bitwise.

    NaN is ordered as ``lax.top_k`` orders it (the reference's ``jnp``
    backend): by its bits with the sign cleared, above inf, and selected
    like any value.  The reference's own sweep differs on a block holding
    a NaN: its ``loop`` extractor (``valid = m >= 0``) drops every
    candidate of that block, its ``bitonic`` one never selects the NaN.
    This sweep follows neither (tests/test_torch_nan_order.py)."""
    if x.device.type == "cpu":
        return segmented_topk_plain(x, seg, kcap, n_cand, block)
    check_sweep("segmented_topk", (x,), seg, kcap, n_cand, block)
    n = x.shape[0]
    nb = -(-n // block)
    if active is None:
        active = active_blocks(seg, block)
    dev = x.device
    cvals = torch.empty((nb * n_cand,), dtype=torch.float32, device=dev)
    cidx = torch.empty((nb * n_cand,), dtype=torch.int32, device=dev)
    cseg = torch.empty((nb * n_cand,), dtype=torch.int32, device=dev)
    a, b = radix_scratch(active, block)
    err = build.library("segmented_topk").segmented_topk(
        x.data_ptr(), seg.data_ptr(), kcap.data_ptr(), active.data_ptr(),
        kcap.numel(), cvals.data_ptr(), cidx.data_ptr(), cseg.data_ptr(),
        a.data_ptr(), b.data_ptr(), n, block, nb, n_cand,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "segmented_topk")
    LAUNCHES["segmented_topk"] += 1
    return cvals, cidx, cseg
