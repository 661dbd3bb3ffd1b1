"""Y = LeakyReLU_0.01(X @ W + b): the LGC encoder's fused matmul.

Counterpart of ``repro.kernels.matmul_lrelu.matmul_bias_lrelu``.
:func:`matmul_bias_lrelu` launches the CUDA kernel
(``csrc/matmul_lrelu.cu``, a tiled GEMM on the tensor cores at f32
accuracy -- 3xTF32 -- with the bias and the activation in its epilogue) for tensors on the card and runs
:func:`matmul_bias_lrelu_plain` for tensors on the CPU.  No padding to the
TPU's 128 tiles: the kernel masks ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build

LEAKY_SLOPE = 0.01


def matmul_bias_lrelu_plain(x, w, b, apply_lrelu: bool = True):
    y = x @ w + b
    return torch.where(y >= 0, y, LEAKY_SLOPE * y) if apply_lrelu else y


def matmul_bias_lrelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      apply_lrelu: bool = True) -> torch.Tensor:
    """x: (M, K), w: (K, N), b: (N,), all f32.  Returns (M, N) f32."""
    if x.device.type == "cpu":
        return matmul_bias_lrelu_plain(x, w, b, apply_lrelu)
    M, K = x.shape
    N = w.shape[1]
    for t in (x, w, b):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("matmul_bias_lrelu: x, w, b must be "
                             "contiguous f32 on one CUDA device")
    if x.device.type != "cuda" or w.shape != (K, N) or b.shape != (N,):
        raise ValueError(f"matmul_bias_lrelu: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} + {tuple(b.shape)} on the card")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = build.library("matmul_lrelu").matmul_bias_lrelu(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K,
        int(bool(apply_lrelu)), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "matmul_bias_lrelu")
    LAUNCHES["matmul_bias_lrelu"] += 1
    return y
