"""The llama-architecture decoder (granite-8b [arXiv:2405.04324]):
pre-norm RMSNorm, grouped-query attention with the half-split rotary
embedding at positions 0..S-1, causal softmax(q k^T / sqrt(hd)) v, a
SwiGLU MLP, the final RMSNorm and the head (the embedding's transpose
where tied).

``params_spec`` names every weight with its shape, stored dtype and
initial distribution, stacked over the layers on a leading axis; the
benchmark draws the weights from it for both sides."""
from __future__ import annotations

import math
from typing import Dict

import torch

from lgcref.common import rmsnorm


def params_spec(cfg: Dict):
    """[(path, shape, dtype, init)]; init ("normal", std), ("ones",)."""
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["vocab_size"]
    H, KH, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    F_ = cfg["intermediate_size"]
    dt = cfg["torch_dtype"]
    a, f = "blocks/p0/mixer/", "blocks/p0/ffn/"
    spec = [
        ("embed/w", (V, D), dt, ("normal", 0.02)),
        ("final_norm/scale", (D,), dt, ("ones",)),
        (a + "norm/scale", (L, D), dt, ("ones",)),
        (a + "wq/w", (L, D, H * hd), dt, ("normal", D ** -0.5)),
        (a + "wk/w", (L, D, KH * hd), dt, ("normal", D ** -0.5)),
        (a + "wv/w", (L, D, KH * hd), dt, ("normal", D ** -0.5)),
        (a + "wo/w", (L, H * hd, D), dt, ("normal", (H * hd) ** -0.5)),
        (f + "norm/scale", (L, D), dt, ("ones",)),
        (f + "w_gate/w", (L, D, F_), dt, ("normal", D ** -0.5)),
        (f + "w_up/w", (L, D, F_), dt, ("normal", D ** -0.5)),
        (f + "w_down/w", (L, F_, D), dt, ("normal", F_ ** -0.5)),
    ]
    if not cfg["tie_word_embeddings"]:
        spec.append(("lm_head/w", (D, V), dt, ("normal", D ** -0.5)))
    return spec


def _rope(x, theta: float):
    """x (B, S, heads, hd): the half-split rotation at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(cfg, mm, x, wn, wq, wk, wv, wo):
    B, S, _ = x.shape
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    h = rmsnorm(x, wn, cfg["rms_norm_eps"])
    q = _rope(mm(h, wq).view(B, S, H, hd), cfg["rope_theta"])
    k = _rope(mm(h, wk).view(B, S, KH, hd), cfg["rope_theta"])
    v = mm(h, wv).view(B, S, KH, hd)
    # query head j reads kv head j // (H / KH)
    k = k.repeat_interleave(H // KH, dim=2)
    v = v.repeat_interleave(H // KH, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, S, hd)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm(p, v).transpose(1, 2).reshape(B, S, H * hd)
    return x + mm(o, wo)


def _swiglu(cfg, mm, x, wn, wg, wu, wd):
    h = rmsnorm(x, wn, cfg["rms_norm_eps"])
    return x + mm(torch.nn.functional.silu(mm(h, wg)) * mm(h, wu), wd)


def layers(cfg: Dict, W: Dict[str, torch.Tensor], i: int):
    """Layer i's [(function, weights)]."""
    a, f = "blocks/p0/mixer/", "blocks/p0/ffn/"
    return [(_attention, [W[a + k][i] for k in (
                "norm/scale", "wq/w", "wk/w", "wv/w", "wo/w")]),
            (_swiglu, [W[f + k][i] for k in (
                "norm/scale", "w_gate/w", "w_up/w", "w_down/w")])]
