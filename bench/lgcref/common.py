"""Pieces the families share: the matmul of the reference (float32) and
of its control (both operands rounded to float8 e4m3), RMSNorm, and the
decoder's loss over the family's layers.

Weights come in as {path: tensor} in float32.  Each layer is recomputed
in the backward (``torch.utils.checkpoint``), so that a full-size cell's
reference fits on the card beside nothing else."""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale (amax to 448),
    back in float32; the backward passes the gradient straight through."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale
    return t + (q - t.detach())


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands in float8 e4m3, the sum in
    float32 (the nearest precision below bfloat16 that a matmul takes)."""
    return to_fp8(a) @ to_fp8(b)


def einsum_of(mm: Matmul):
    """``torch.einsum`` whose operands go through the same rounding as
    ``mm``'s."""
    if mm is f32_mm:
        return torch.einsum

    def ein(eq, *ops):
        return torch.einsum(eq, *(to_fp8(o) for o in ops))
    return ein


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def loss(family, cfg: Dict, W: Dict[str, torch.Tensor], tokens, labels,
         mm: Matmul = f32_mm) -> torch.Tensor:
    """Mean next-token cross-entropy (every label valid) of the decoder
    of ``family`` (a module with ``layers(cfg, W, i)``: layer i's
    [(function, weights)]).  tokens, labels (B, S) int64."""
    x = W["embed/w"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        for fn, ws in family.layers(cfg, W, i):
            x = checkpoint(fn, cfg, mm, x, *ws, use_reentrant=False)
    h = rmsnorm(x, W["final_norm/scale"], cfg["rms_norm_eps"])
    head = W["embed/w"].t() if cfg["tie_word_embeddings"] \
        else W["lm_head/w"]
    logits = mm(h, head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
