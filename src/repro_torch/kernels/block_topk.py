"""Per-block exact top-k by |x| (kernel K6).

Counterpart of ``repro.kernels.block_topk.block_topk`` and its oracle
``repro.kernels.ref.block_topk_ref``: per row of x (n_blocks, block), the
kb elements of largest |x|, emitted |x| descending then lowest index
first, as (values, block-local int32 indices).  :func:`block_topk`
launches the CUDA kernel (``csrc/block_topk.cu``: one CTA per block, a
stable LSD radix sort on the magnitude rank with the index riding along,
the last pass writing the first kb positions) for tensors on the card and
runs :func:`block_topk_plain` for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.segmented_topk import (LANE, LOC_BITS,
                                                magnitude_rank)


def block_topk_plain(x: torch.Tensor, kb: int):
    """The plain PyTorch version: per row, the kb smallest unique int64
    keys magnitude_rank << 32 | index."""
    block = x.shape[1]
    key = magnitude_rank(x) << 32 | torch.arange(block, device=x.device)
    idx = torch.topk(key, kb, dim=1, largest=False, sorted=True).indices
    return x.gather(1, idx), idx.to(torch.int32)


def block_topk(x: torch.Tensor, kb: int):
    """x: (n_blocks, block) f32, block % 128 == 0, block <= 2^17,
    0 < kb <= block.
    Returns (vals (n_blocks, kb) f32, idx (n_blocks, kb) int32 local to
    the block); the same outputs as :func:`block_topk_plain`, bitwise.

    A NaN ranks by its bits with the sign cleared, above inf, as in
    ``lax.top_k`` (the reference's ``jnp`` backend and per-leaf oracle).
    The reference's Pallas ``block_topk`` differs on a row holding a
    NaN: no position equals a NaN maximum, so from then on it emits
    (0.0, block) for every slot; this kernel does not copy that
    (tests/test_torch_nan_order.py)."""
    if x.device.type == "cpu":
        return block_topk_plain(x, kb)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("block_topk: x must be a contiguous (n_blocks, "
                         "block) f32 tensor on the card")
    nb, block = x.shape
    # the index rides in LOC_BITS bits of the sort word; one CTA per block
    if not (LANE <= block <= 1 << LOC_BITS and block % LANE == 0) \
            or not 0 < kb <= block or not 0 < nb < 2 ** 31:
        raise ValueError(f"block_topk: unsupported n_blocks={nb}, "
                         f"block={block}, kb={kb}")
    dev = x.device
    vals = torch.empty((nb, kb), dtype=torch.float32, device=dev)
    idx = torch.empty((nb, kb), dtype=torch.int32, device=dev)
    # the radix passes' ping-pong scratch: a 64-bit and a 32-bit word per
    # element (the later passes' words fit 32 bits)
    a = torch.empty((nb * block,), dtype=torch.int64, device=dev)
    b = torch.empty((nb * block,), dtype=torch.int32, device=dev)
    err = build.library("block_topk").block_topk(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), a.data_ptr(),
        b.data_ptr(), nb, block, kb,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "block_topk")
    LAUNCHES["block_topk"] += 1
    return vals, idx
