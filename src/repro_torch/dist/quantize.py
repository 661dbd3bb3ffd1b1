"""Symmetric int8 block quantization (counterpart of
``repro.dist.quantize``): the value half of the packed sparse wire, and
the int8 byte count every pricer charges.

The flat values are zero-padded to a multiple of ``scale_block``; each
block gets one f32 scale, max(max|x|, eps) · f32(1/127), and its values
round half to even into [-127, 127].  Non-finite values quantize to 0
and, under a guard, are counted.
The scale multiplies by the f32 reciprocal because that is what the
reference computes where it runs, under ``jit``: XLA turns its division
by the constant 127 into that multiplication (an eager call of the
reference divides, and its scales then differ in the last bit).
``x / scale`` has no constant divisor and stays a true division.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import chaos as CH
from repro_torch.kernels import bitpack as BP
from repro_torch.utils import fma_f32

SCALE_BLOCK = 256     # values per f32 scale: 4/256 = 1.6% byte overhead
_EPS = 1e-12          # all-zero blocks quantize to 0 without dividing by 0


def _blocked(x: torch.Tensor, scale_block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.shape[0]) % scale_block)
                 ).view(-1, scale_block)


def quantize_i8(x: torch.Tensor, scale_block: int = SCALE_BLOCK):
    """-> (q int8 (m, scale_block), scales f32 (m,)) of the flattened,
    zero-padded ``x``.  Non-finite values quantize to 0, and their count
    goes to the guard's sink when one is open."""
    xb = _blocked(x.to(torch.float32), scale_block)
    finite = torch.isfinite(xb)
    if CH.structural_sink_active():
        CH.report_structural((~finite).sum())
    xb = torch.where(finite, xb, torch.zeros_like(xb))
    scales = torch.clamp(xb.abs().amax(1), min=_EPS) \
        * BP.f32_reciprocal(127, xb.device)
    q = torch.clamp(torch.round(xb / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def dequantize_i8(q: torch.Tensor, scales: torch.Tensor, n: int,
                  shape=None) -> torch.Tensor:
    """Inverse of :func:`quantize_i8`: drop the padding, restore shape.
    A leading batch of (q, scales) pairs, (B, m, scale_block) and (B, m),
    gives (B, n)."""
    flat = (q.to(torch.float32) * scales[..., None]
            ).reshape(*q.shape[:-2], -1)[..., :n]
    return flat.reshape(shape) if shape is not None else flat


def dequantize_add_i8(q: torch.Tensor, scales: torch.Tensor, n: int,
                      acc: torch.Tensor) -> torch.Tensor:
    """``dequantize_i8(q, scales, n) + acc`` (acc flat (n,)) with each
    product and its sum rounded once: under ``jit`` XLA fuses the
    reference's dequantize into the add that consumes it and contracts
    the pair into one FMA."""
    scale_of = scales[:, None].expand(q.shape).reshape(-1)[:n]
    return fma_f32(scale_of, q.to(torch.float32).reshape(-1)[:n], acc)


def fake_quantize(x: torch.Tensor, scale_block: int = SCALE_BLOCK):
    """The quantize -> dequantize roundtrip in the float domain."""
    q, scales = quantize_i8(x, scale_block)
    return dequantize_i8(q, scales, x.numel(), x.shape)


def quantize_pack_fused(vals: torch.Tensor, idx_lo: torch.Tensor,
                        width: int, scale_block: int = SCALE_BLOCK):
    """One launch of K4: ``vals`` block-quantized as :func:`quantize_i8`
    does, and the masked low index bits ``idx_lo`` packed into (width,
    ceil(k/32)) planes.  Returns (words, q, scales)."""
    return BP.quantize_pack(vals, idx_lo, width, scale_block, _EPS)


def wire_nbytes(n: int, scale_block: int = SCALE_BLOCK) -> int:
    """Wire bytes of ``n`` values on the int8 wire: the padded int8
    payload + one f32 scale per block."""
    m = -(-n // scale_block)
    return m * scale_block * 1 + m * 4
