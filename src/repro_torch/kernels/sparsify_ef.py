"""Fused error-feedback accumulate + exact segmented top-k candidates.

Counterpart of ``repro.kernels.sparsify_ef.sparsify_ef_topk``: one sweep
computes u' = m*u + g, v' = v + u' (sparse_gd: v' = v + g, u unchanged)
and, per block, every slot piece's top-min(kcap, |piece|) candidates of
v' as (value, global index, slot) triples.  :func:`sparsify_ef_topk`
launches the CUDA kernel (``csrc/sparsify_ef.cu``) for tensors on the
card and runs :func:`sparsify_ef_topk_plain` for tensors on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.segmented_topk import (LOC_BITS, next_pow2,
                                                select_candidates)

# the cap pass keeps one int counter per slot in dynamic shared memory;
# with its 1.3 KB of static shared memory it must stay within the 48 KB a
# launch gets without opting in
_MAX_SLOTS = 11 * 1024


def active_blocks(seg: torch.Tensor, block: int) -> torch.Tensor:
    """(n_blocks,) int32: each block's row in the kernel's key scratch, or
    -1 for a block with no selectable element (seg < 0 throughout)."""
    n = seg.shape[0]
    full = n // block
    has = seg[:full * block].view(full, block).amax(1) >= 0
    if n > full * block:
        has = torch.cat([has, (seg[full * block:].amax() >= 0)[None]])
    return torch.where(has, torch.cumsum(has, 0) - 1, -1).to(torch.int32)


def sparsify_ef_topk_plain(g, u, v, seg, kcap, momentum: float,
                           use_momentum: bool, n_cand: int, block: int):
    """The plain PyTorch version: separate multiply and add (no fused
    multiply-add), then the sort-based extractor over the zero-padded
    blocks.  Returns (u', v', vals, idx, seg), the last three flat
    (n_blocks * n_cand,)."""
    if use_momentum:
        u2 = momentum * u + g
        v2 = v + u2
    else:
        u2 = u.clone()
        v2 = v + g
    n = g.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    vals, idx, segs = select_candidates(
        F.pad(v2, (0, pad)).view(nb, block),
        F.pad(seg, (0, pad), value=-1).view(nb, block), kcap, n_cand)
    base = torch.arange(nb, device=g.device, dtype=torch.int32) * block
    return (u2, v2, vals.reshape(-1), (idx + base[:, None]).reshape(-1),
            segs.reshape(-1))


def sparsify_ef_topk(g, u, v, seg, kcap, momentum: float,
                     use_momentum: bool, n_cand: int, block: int,
                     active=None):
    """g, u, v: (n,) f32; seg: (n,) int32 slot per element (-1 = not
    selectable); kcap: (n_slots,) int32.  ``active`` is
    :func:`active_blocks` (computed here when not given).  Same outputs
    as :func:`sparsify_ef_topk_plain`, bitwise."""
    if g.device.type == "cpu":
        return sparsify_ef_topk_plain(g, u, v, seg, kcap, momentum,
                                      use_momentum, n_cand, block)
    n = g.shape[0]
    nb = -(-n // block)
    for t, dt in ((g, torch.float32), (u, torch.float32),
                  (v, torch.float32), (seg, torch.int32),
                  (kcap, torch.int32)):
        if t.device != g.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("sparsify_ef_topk: g, u, v f32 and seg, kcap "
                             "int32, contiguous, on one CUDA device")
    if g.device.type != "cuda" or u.shape != (n,) or v.shape != (n,) \
            or seg.shape != (n,):
        raise ValueError("sparsify_ef_topk: g, u, v, seg must be (n,) on "
                         "the card")
    if not (256 <= block <= 1 << LOC_BITS and block % 128 == 0) \
            or nb * block >= 2 ** 31 or not 0 < n_cand <= block \
            or not 0 < kcap.numel() <= _MAX_SLOTS:
        raise ValueError(f"sparsify_ef_topk: unsupported block={block}, "
                         f"n={n}, n_cand={n_cand}, slots={kcap.numel()}")
    if active is None:
        active = active_blocks(seg, block)
    n_active = int(active.max()) + 1
    dev = g.device
    u_out = torch.empty_like(g)
    v_out = torch.empty_like(g)
    cvals = torch.empty((nb, n_cand), dtype=torch.float32, device=dev)
    cidx = torch.empty((nb, n_cand), dtype=torch.int32, device=dev)
    cseg = torch.empty((nb, n_cand), dtype=torch.int32, device=dev)
    keys = torch.empty((max(n_active, 1) * next_pow2(block),),
                       dtype=torch.int64, device=dev)
    err = build.library("sparsify_ef").fused_ef_topk(
        g.data_ptr(), u.data_ptr(), v.data_ptr(), seg.data_ptr(),
        kcap.data_ptr(), active.data_ptr(), kcap.numel(), u_out.data_ptr(),
        v_out.data_ptr(), cvals.data_ptr(), cidx.data_ptr(),
        cseg.data_ptr(), keys.data_ptr(), n, block, nb, n_active, n_cand,
        float(momentum), int(bool(use_momentum)),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_ef_topk")
    LAUNCHES["fused_ef_topk"] += 1
    return (u_out, v_out, cvals.view(-1), cidx.view(-1), cseg.view(-1))
