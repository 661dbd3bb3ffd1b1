"""Bit-plane packing of int32 values and the fused sparse-wire encode
(kernels K5a, K5b and K4).

Counterpart of ``repro.kernels.bitpack``.  k values at ``width`` bits pack
into ``width`` planes of W = ceil(k/32) int32 words: the values, zero
padded to 32·W, are read as a (32, W) row-major array, and

    word[b, j] = sum_r ((x[r·W + j] >> b) & 1) << r

so word j gathers values j, W + j, 2W + j, ... (not 32 consecutive ones).
:func:`unpack_bits` is the exact inverse.  :func:`quantize_pack`
block-quantizes the values to int8 with one f32 scale per ``scale_block``
and packs the index low bits in one launch.  Each wrapper launches its
CUDA kernel (``csrc/bitpack.cu``) for tensors on the card and runs its
plain version for tensors on the CPU.  The reference splits whole
128-word tiles (its Pallas kernel) from the tail (jnp); that split is TPU
layout, and one pass over all W words gives the same words.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, build

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


def f32_reciprocal(d: int, device=None) -> torch.Tensor:
    """float32(1/d) as a 0-dim tensor, rounded once in f32: what XLA
    multiplies by where the reference divides by the constant ``d``
    under ``jit``."""
    one = torch.ones((), dtype=torch.float32, device=device)
    return one / torch.full((), float(d), dtype=torch.float32,
                            device=device)


# -- plain versions -----------------------------------------------------------


def _rows(x: torch.Tensor, W: int) -> torch.Tensor:
    """(k,) -> the zero-padded (32, W) int32 row-major view."""
    x = x.to(torch.int32)
    return F.pad(x, (0, GROUP * W - x.shape[0])).view(GROUP, W)


def pack_bits_plain(x: torch.Tensor, width: int) -> torch.Tensor:
    r = torch.arange(GROUP, dtype=torch.int32, device=x.device)[:, None]
    rows = _rows(x, word_count(x.shape[0]))
    return torch.stack([(((rows >> b) & 1) << r).sum(0, dtype=torch.int32)
                        for b in range(width)])


def unpack_bits_plain(words: torch.Tensor, k: int) -> torch.Tensor:
    *lead, width, W = words.shape
    r = torch.arange(GROUP, dtype=torch.int32, device=words.device)[:, None]
    acc = torch.zeros((*lead, GROUP, W), dtype=torch.int32,
                      device=words.device)
    for b in range(width):
        acc |= ((words[..., b, None, :] >> r) & 1) << b
    return acc.reshape(*lead, GROUP * W)[..., :k]


def quantize_pack_plain(vals: torch.Tensor, idx_lo: torch.Tensor,
                        width: int, scale_block: int, eps: float):
    """The reference kernel's arithmetic: per block, non-finite values to
    0, scale = max(max|x|, eps) · f32(1/127), q = clip(round_half_even(x
    / scale), ±127); and the bit planes of ``idx_lo``."""
    k = vals.shape[0]
    m = -(-k // scale_block)
    xb = F.pad(vals.to(torch.float32), (0, m * scale_block - k)
               ).view(m, scale_block)
    xb = torch.where(torch.isfinite(xb), xb, torch.zeros_like(xb))
    scales = torch.clamp(xb.abs().amax(1), min=eps) \
        * f32_reciprocal(127, xb.device)
    q = torch.clamp(torch.round(xb / scales[:, None]), -127, 127)
    return pack_bits_plain(idx_lo, width), q.to(torch.int8), scales


# -- wrappers -----------------------------------------------------------------

_ENTRIES = {}     # C entry points of csrc/bitpack.cu, bound at first launch


def _entry(name: str):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(build.library("bitpack"), name)
    return fn


def _check(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda" or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name}: inputs must be contiguous 1-D tensors "
                             "on the card")


def _stream(dev) -> int:
    """The raw handle of ``dev``'s current stream, where the launch goes:
    the getter PyTorch's own generated code uses, without building the
    Stream object of ``torch.cuda.current_stream(dev)``."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def pack_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """(k,) int32 values in [0, 2**width) -> (width, word_count(k)) int32
    planes; bits above ``width`` are dropped."""
    assert 1 <= width <= MAX_WIDTH, width
    if x.device.type == "cpu":
        return pack_bits_plain(x, width)
    _check("pack_bits", x)
    if x.dtype != torch.int32 or x.shape[0] < 1:
        raise ValueError("pack_bits: x must be a non-empty int32 tensor")
    k, W = x.shape[0], word_count(x.shape[0])
    words = torch.empty((width, W), dtype=torch.int32, device=x.device)
    build.check(_entry("pack_bits")(
        x.data_ptr(), words.data_ptr(), k, width, W, _stream(x.device)),
        "pack_bits")
    LAUNCHES["pack_bits"] += 1
    return words


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (width, W) planes -> the first ``k``
    values, or a (B, width, W) stack of them (a gathered table) -> (B, k),
    bit-exact; one launch either way."""
    if words.dim() not in (2, 3):
        raise ValueError("unpack_bits: words must be (width, W) or (B, "
                         "width, W)")
    width, W = words.shape[-2:]
    assert 1 <= width <= MAX_WIDTH and 1 <= k <= GROUP * W, (width, W, k)
    dev = words.device
    if dev.type == "cpu":
        return unpack_bits_plain(words, k)
    B = words.shape[0] if words.dim() == 3 else 1
    if dev.type != "cuda" or words.dtype != torch.int32 \
            or not words.is_contiguous() or not 1 <= B <= 65535:
        raise ValueError("unpack_bits: words must be contiguous int32 on "
                         "the card, with 1 to 65535 stacked")
    out = torch.empty(words.shape[:-2] + (k,), dtype=torch.int32, device=dev)
    build.check(_entry("unpack_bits")(
        words.data_ptr(), out.data_ptr(), B, k, width, W, _stream(dev)),
        "unpack_bits")
    LAUNCHES["unpack_bits"] += 1
    return out


def quantize_pack(vals: torch.Tensor, idx_lo: torch.Tensor, width: int,
                  scale_block: int, eps: float):
    """One launch: ``vals`` (k,) f32 -> (q int8 (m, scale_block), scales
    f32 (m,)), m = ceil(k/scale_block), and ``idx_lo`` (k,) int32 ->
    (width, word_count(k)) planes.  Returns (words, q, scales); on the
    card they are views of one allocation."""
    assert 1 <= width <= MAX_WIDTH, width
    k = vals.shape[0]
    assert k >= 1 and idx_lo.shape == (k,), (vals.shape, idx_lo.shape)
    if vals.device.type == "cpu":
        return quantize_pack_plain(vals, idx_lo, width, scale_block, eps)
    _check("quantize_pack", vals, idx_lo)
    if vals.dtype != torch.float32 or idx_lo.dtype != torch.int32 \
            or idx_lo.device != vals.device or scale_block < 1:
        raise ValueError("quantize_pack: vals f32 and idx_lo int32 on one "
                         "card, scale_block >= 1")
    dev = vals.device
    W, m = word_count(k), -(-k // scale_block)
    # words, scales, then q in one int32 allocation, each 4-byte aligned
    nw = width * W
    buf = torch.empty((nw + m + -(-m * scale_block // 4),),
                      dtype=torch.int32, device=dev)
    words = buf.as_strided((width, W), (W, 1))
    scales = buf.view(torch.float32).as_strided((m,), (1,), nw)
    q = buf.view(torch.int8).as_strided((m, scale_block), (scale_block, 1),
                                        4 * (nw + m))
    build.check(_entry("quantize_pack")(
        vals.data_ptr(), idx_lo.data_ptr(), words.data_ptr(), q.data_ptr(),
        scales.data_ptr(), k, width, W, m, scale_block, eps, _stream(dev)),
        "quantize_pack")
    LAUNCHES["quantize_pack"] += 1
    return words, q, scales
