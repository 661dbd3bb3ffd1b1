"""Per-block segmented candidate extraction, in plain PyTorch.

Counterpart of ``repro.kernels.segmented_topk.select_candidates`` (the
"loop" extractor) and ``repro.kernels.bitonic.select_candidates_bitonic``
(the "bitonic" one): the reference proves the two bit-identical, so one
plain version serves both.  It is the plain version of the fused sweep
kernel (``sparsify_ef``) and runs vectorised over all blocks with two
sorts on unique int64 keys, which reproduce ``lax.top_k``'s order
(|value| descending, lowest index first) exactly.
"""
from __future__ import annotations

import torch

LANE = 128
BLOCK = 8 * LANE          # default sweep block (one (8, 128) TPU tile)
LOC_BITS = 17             # local index bits: blocks are <= 2^17 elements
_MAG_MAX = 0x7FFFFFFF


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def magnitude_rank(x: torch.Tensor) -> torch.Tensor:
    """int64 key ascending in |x| descending: 0x7FFFFFFF - bits(|x|)."""
    return _MAG_MAX - x.abs().view(torch.int32).to(torch.int64)


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
