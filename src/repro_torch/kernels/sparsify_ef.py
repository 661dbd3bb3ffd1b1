"""The error-feedback kernels: the fused accumulate + exact segmented
top-k candidates (K1) and the threshold pass (K7).

:func:`sparsify_ef_topk` is the counterpart of
``repro.kernels.sparsify_ef.sparsify_ef_topk``: one sweep computes
u' = m*u + g (one FMA), v' = v + u' (sparse_gd: v' = v + g, u unchanged)
and, per block, every slot piece's top-min(kcap, |piece|) candidates of
v' as (value, global index, slot) triples.  :func:`sparsify_ef` is the
counterpart of ``repro.kernels.sparsify_ef.sparsify_ef``: the same
accumulate, then the coordinates with |v'| >= tau are sent and cleared.
Each wrapper launches its CUDA kernel (``csrc/sparsify_ef.cu``) for
tensors on the card and runs its plain version for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.segmented_topk import (active_blocks, check_sweep,
                                                radix_scratch,
                                                segmented_topk_plain)
from repro_torch.utils import fma_f32


def sparsify_ef_topk_plain(g, u, v, seg, kcap, momentum: float,
                           use_momentum: bool, n_cand: int, block: int):
    """The plain PyTorch version: u' = m*u + g as one fused multiply-add,
    as the reference's kernel computes it, then the segmented extractor
    of v'.  Returns (u', v', vals, idx, seg), the last three flat
    (n_blocks * n_cand,)."""
    if use_momentum:
        u2 = fma_f32(momentum, u, g)
        v2 = v + u2
    else:
        u2 = u.clone()
        v2 = v + g
    return (u2, v2) + segmented_topk_plain(v2, seg, kcap, n_cand, block)


def sparsify_ef_topk(g, u, v, seg, kcap, momentum: float,
                     use_momentum: bool, n_cand: int, block: int,
                     active=None):
    """g, u, v: (n,) f32; seg: (n,) int32 slot per element (-1 = not
    selectable); kcap: (n_slots,) int32.  ``active`` is
    :func:`active_blocks` (computed here when not given).  Same outputs
    as :func:`sparsify_ef_topk_plain`, bitwise.

    A NaN in v' is selected in ``lax.top_k``'s order (the reference's
    ``jnp`` backend): by its bits with the sign cleared, above inf.  The
    reference's fused kernel differs on a block holding a NaN (its
    ``loop`` extractor drops the whole block's candidates, its ``bitonic``
    one skips the NaN); this one follows neither
    (tests/test_torch_nan_order.py)."""
    if g.device.type == "cpu":
        return sparsify_ef_topk_plain(g, u, v, seg, kcap, momentum,
                                      use_momentum, n_cand, block)
    check_sweep("sparsify_ef_topk", (g, u, v), seg, kcap, n_cand, block)
    n = g.shape[0]
    nb = -(-n // block)
    if active is None:
        active = active_blocks(seg, block)
    dev = g.device
    u_out = torch.empty_like(g)
    v_out = torch.empty_like(g)
    cvals = torch.empty((nb, n_cand), dtype=torch.float32, device=dev)
    cidx = torch.empty((nb, n_cand), dtype=torch.int32, device=dev)
    cseg = torch.empty((nb, n_cand), dtype=torch.int32, device=dev)
    a, b = radix_scratch(active, block)
    err = build.library("sparsify_ef").fused_ef_topk(
        g.data_ptr(), u.data_ptr(), v.data_ptr(), seg.data_ptr(),
        kcap.data_ptr(), active.data_ptr(), kcap.numel(), u_out.data_ptr(),
        v_out.data_ptr(), cvals.data_ptr(), cidx.data_ptr(),
        cseg.data_ptr(), a.data_ptr(), b.data_ptr(), n, block, nb, n_cand,
        float(momentum), int(bool(use_momentum)),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_ef_topk")
    LAUNCHES["fused_ef_topk"] += 1
    return (u_out, v_out, cvals.view(-1), cidx.view(-1), cseg.view(-1))


def sparsify_ef_plain(g, u, v, tau, momentum: float):
    """The plain PyTorch version of the threshold pass: u' = m*u + g (one
    FMA), v' = v + u', keep = |v'| >= tau (never for NaN).  Returns
    (u_out, v_out, sent): u', v' with +0 where kept, and v' where kept
    with +0 elsewhere."""
    u2 = fma_f32(momentum, u, g)
    v2 = v + u2
    tau = torch.as_tensor(tau, dtype=torch.float32, device=v2.device)
    keep = v2.abs() >= tau
    zero = torch.zeros((), dtype=torch.float32, device=v2.device)
    return (torch.where(keep, zero, u2), torch.where(keep, zero, v2),
            torch.where(keep, v2, zero))


def sparsify_ef(g, u, v, tau, momentum: float):
    """g, u, v: (n,) f32, any n; ``tau`` a float or a one-element f32
    tensor (read on the card, so a threshold computed there needs no
    sync).  Same outputs as :func:`sparsify_ef_plain`, bitwise."""
    if g.device.type == "cpu":
        return sparsify_ef_plain(g, u, v, tau, momentum)
    n = g.shape[0]
    for t in (g, u, v):
        if t.device != g.device or t.device.type != "cuda" \
                or t.dtype != torch.float32 or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError("sparsify_ef: g, u, v must be contiguous (n,) "
                             "f32 tensors on one card")
    tau_t = torch.as_tensor(tau, dtype=torch.float32,
                            device=g.device).reshape(1).contiguous()
    u_out, v_out, sent = (torch.empty_like(g) for _ in range(3))
    err = build.library("sparsify_ef").sparsify_ef(
        g.data_ptr(), u.data_ptr(), v.data_ptr(), tau_t.data_ptr(),
        float(momentum), u_out.data_ptr(), v_out.data_ptr(),
        sent.data_ptr(), n, torch.cuda.current_stream(g.device).cuda_stream)
    build.check(err, "sparsify_ef")
    LAUNCHES["sparsify_ef"] += 1
    return u_out, v_out, sent
