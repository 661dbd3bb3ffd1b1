"""Wrappers around the kernels: the threshold EF pass and its sampled
threshold, exact global top-k through the block top-k kernel, the
segmented and fused sweep entry points, and the LGC encoder lowered onto
the fused matmul (im2col + matmul_bias_lrelu).

Counterpart of ``repro.kernels.ops`` (``estimate_threshold``,
``sparsify_ef``, ``global_topk``, ``segmented_topk``, ``fused_ef_topk``,
``_im2col_1d``, ``conv1d_lrelu``, ``lgc_encode_fast``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.autoencoder import ENCODER_SPEC
from repro_torch.kernels import segmented_topk as _st
from repro_torch.kernels import sparsify_ef as _ef
from repro_torch.kernels.block_topk import block_topk
from repro_torch.kernels.matmul_lrelu import matmul_bias_lrelu
# the threshold EF pass (K7) over flat vectors of any length: the
# reference pads to whole 64Ki tiles and slices back to n, the kernel
# covers any n
from repro_torch.kernels.sparsify_ef import sparsify_ef  # noqa: F401

EXTRACT = ("loop", "bitonic")
_MASKED = torch.iinfo(torch.int64).max


def estimate_threshold(v: torch.Tensor, k: int,
                       sample_stride: int = 32) -> torch.Tensor:
    """DGC's sampled threshold: the k_s-th largest |v| over every
    ``sample_stride``-th element, k_s = max(1, min(len, ceil(k /
    stride))).  A 0-dim tensor on v's device; a value, so the order of
    ties cannot change it."""
    sample = v[::sample_stride].abs()
    k_s = max(1, min(sample.shape[0], -(-k // sample_stride)))
    return torch.topk(sample, k_s, sorted=True).values[-1]



def global_topk(x: torch.Tensor, k: int, block: int = 64 * 128):
    """Exact top-k by |x| of a flat x: zero-pad to the block, keep each
    block's top-min(k, block) (kernel K6), then merge the candidates with
    the padding masked out.  The merge keys are unique (magnitude rank,
    global index), which is lax.top_k's order over the reference's
    block-major candidate pool.  Returns (values (k,), global indices (k,)
    int32), |x| descending, lowest index first."""
    n = x.shape[0]
    nb = -(-n // block)
    xp = F.pad(x, (0, nb * block - n))
    vals, idx = block_topk(xp.view(nb, block), min(k, block))
    del xp
    cand_vals = vals.reshape(-1)
    cand_idx = (idx + (torch.arange(nb, dtype=torch.int32, device=x.device)
                       * block)[:, None]).reshape(-1)
    key = torch.where(cand_idx < n,
                      _st.magnitude_rank(cand_vals) << 32 | cand_idx,
                      _MASKED)
    top = torch.topk(key, k, largest=False, sorted=True).indices
    return cand_vals[top], cand_idx[top]


def segmented_topk(x, seg, kcap, n_cand: int, block: int = _st.BLOCK,
                   extract: str = "loop", active=None):
    """Candidate sweep over a flat vector of any length: the plain version
    pads x with zeros and seg with -1 to whole blocks, the kernel masks
    the ragged last block.  ``extract`` names the reference's per-block
    extractor, which picked ``block``; both give the same triples.
    Returns flat (cand_vals, cand_idx, cand_seg), idx global."""
    if extract not in EXTRACT:
        raise ValueError(f"unknown extract backend: {extract!r}")
    return _st.segmented_topk(x, seg, kcap, n_cand, block, active)


def fused_ef_topk(g, u, v, seg, kcap, momentum: float, use_momentum: bool,
                  n_cand: int, block: int, extract: str = "loop",
                  active=None):
    """One-sweep EF accumulate + segmented top-k candidates over a flat
    vector of any length (the kernel masks the ragged last block).
    ``extract`` names the reference's per-block extractor, which picked
    ``block``; both give the same triples, and so does the one algorithm
    here.  Returns (u', v', cand_vals, cand_idx, cand_seg), flat."""
    if extract not in EXTRACT:
        raise ValueError(f"unknown extract backend: {extract!r}")
    return _ef.sparsify_ef_topk(g, u, v, seg, kcap, momentum, use_momentum,
                                n_cand, block, active)


def _im2col_1d(x: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """x: (L, C) -> (L_out, ksize*C), SAME padding as lax (lo = total//2)."""
    L, C = x.shape
    L_out = (L + stride - 1) // stride
    pad_total = max((L_out - 1) * stride + ksize - L, 0)
    lo = pad_total // 2
    xp = F.pad(x, (0, 0, lo, pad_total - lo))
    cols = xp.unfold(0, ksize, stride)                    # (L_out, C, k)
    return cols.transpose(1, 2).reshape(L_out, ksize * C)


def conv1d_lrelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int, apply_lrelu: bool = True) -> torch.Tensor:
    """One LGC-AE conv layer on the fused matmul.  x: (L, C_in); w:
    (ksize, C_in, C_out) WIO.  Returns (L_out, C_out) f32."""
    ksize, c_in, c_out = w.shape
    cols = _im2col_1d(x, ksize, stride).contiguous()   # windows overlap
    return matmul_bias_lrelu(cols, w.reshape(ksize * c_in, c_out)
                             .contiguous(), b.contiguous(), apply_lrelu)


def lgc_encode_fast(ae_params, g: torch.Tensor) -> torch.Tensor:
    """Kernel-backed ``core.autoencoder.lgc_encode`` for one vector g:
    (L,) with L % 16 == 0.  Returns (L/16, 4)."""
    x = g[:, None].to(torch.float32)
    for p, (_c, _k, s) in zip(ae_params["encoder"], ENCODER_SPEC):
        x = conv1d_lrelu(x, p["w"], p["b"], s)
    return x
