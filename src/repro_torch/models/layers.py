"""Dense decoder building blocks (counterpart of ``repro.models.layers``,
dense subset).  Params are nested dicts of tensors in the reference's
layouts: linear weights (in, out), a leading ``lead`` axis on stacked
block params.

Training and prefill attend through ``flash.flash_attention``, as the
reference's ``attention_fwd`` does: an online softmax over chunks whose
backward recomputes the probabilities, so no (S, S) score matrix is
ever held and the prompt and training lengths are bounded by the
weights, the cache and one layer's activations, not by S².
``blockwise_attention`` (defined in ``flash``) is the same forward
with explicit positions.

Decode (``attention_decode`` over the cache of ``init_attention_cache``)
is plain PyTorch, as the reference's ``decode_attention`` is plain jnp:
one query row against the cache needs no chunking.  Unlike the
reference's functional update, it writes the new token's k, v and
position into the cache IN PLACE.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import flash
from repro_torch.models.flash import blockwise_attention  # noqa: F401


def _dense_init(gen: torch.Generator, shape: Sequence[int], dtype, device,
                scale: Optional[float] = None, lead: Sequence[int] = ()):
    """Normal(0, scale) with scale = 1/sqrt(fan_in) unless given; ``lead``
    prepends stacked-block axes (each slice is one block's weight)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    meta = torch.device(device).type == "meta"     # shapes only
    w = torch.randn(tuple(lead) + tuple(shape), device=device,
                    generator=None if meta else gen, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def init_linear(gen, d_in, d_out, dtype, device, bias=False, lead=()):
    p = {"w": _dense_init(gen, (d_in, d_out), dtype, device, lead=lead)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                             device=device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_rmsnorm(d, dtype, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(p, x, eps=1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, heads, head_dim); positions: (S,).  Half-split rotation."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[:, None] * freqs           # (S, hd/2)
    cos = torch.cos(angles)[:, None, :]                   # (S, 1, hd/2)
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_attention(gen, cfg: ModelConfig, dtype, device, lead=()):
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "norm": init_rmsnorm(D, dtype, device, lead),
        "wq": init_linear(gen, D, H * hd, dtype, device, cfg.qkv_bias, lead),
        "wk": init_linear(gen, D, KH * hd, dtype, device, cfg.qkv_bias, lead),
        "wv": init_linear(gen, D, KH * hd, dtype, device, cfg.qkv_bias, lead),
        "wo": init_linear(gen, H * hd, D, dtype, device, False, lead),
    }


def attention_fwd(p, cfg: ModelConfig, x, positions):
    """Pre-norm self-attention with residual, for training and prefill.
    x: (B, S, D).  Returns (x + attention, (k, v)): the roped keys and the
    values, (B, S, KH, hd) each, which prefill keeps as the cache."""
    B, S, _ = x.shape
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps)
    q = linear(p["wq"], h).view(B, S, cfg.n_heads, cfg.head_dim)
    k = linear(p["wk"], h).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = linear(p["wv"], h).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash.flash_attention(q, k, v, True, cfg.sliding_window)
    return x + linear(p["wo"], o.reshape(B, S, -1)), (k, v)


def decode_attention(q, k_cache, v_cache, *, kv_positions, pos: int,
                     window: int = 0):
    """Single-token attention against a (possibly only partially valid)
    cache.  q: (B, 1, H, D); caches: (B, S, KH, D); kv_positions: (S,)
    absolute positions held by each cache slot; pos: the current
    position.  Slots with kv_positions > pos (unwritten: the int32-max
    sentinel) are masked, and under a window those pos - window or
    older.  Scores and softmax in f32; returns (B, 1, H, D) in q's
    dtype."""
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    qr = q.reshape(B, KH, H // KH, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    valid = kv_positions <= pos
    if window:
        valid &= pos - kv_positions < window
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def attention_decode(p, cfg: ModelConfig, x, cache, pos: int):
    """x: (B, 1, D); cache: {"k", "v": (B, S, KH, hd), "pos": (S,) int32
    absolute positions}.  The token's k, v and position go into slot
    ``pos`` (``pos % S`` under a sliding window: a ring buffer) IN PLACE.
    Returns (x + attention, cache)."""
    B = x.shape[0]
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps)
    q = linear(p["wq"], h).view(B, 1, cfg.n_heads, cfg.head_dim)
    k = linear(p["wk"], h).view(B, 1, cfg.n_kv_heads, cfg.head_dim)
    v = linear(p["wv"], h).view(B, 1, cfg.n_kv_heads, cfg.head_dim)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    S = cache["k"].shape[1]
    slot = pos % S if cfg.sliding_window else pos
    if not 0 <= slot < S:
        raise IndexError(f"decode position {pos} is past the cache's "
                         f"{S} slots")
    cache["k"][:, slot].copy_(k[:, 0])
    cache["v"][:, slot].copy_(v[:, 0])
    cache["pos"][slot:slot + 1].fill_(pos)     # no host-to-device copy
    o = decode_attention(q, cache["k"], cache["v"],
                         kv_positions=cache["pos"], pos=pos,
                         window=cfg.sliding_window)
    return x + linear(p["wo"], o.reshape(B, 1, -1)), cache


INT32_MAX = 2 ** 31 - 1       # a cache slot's position before it is written


def init_attention_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                         device, lead=()):
    """Zero k, v (lead + (B, S, KH, hd)) and int32-max positions
    (lead + (S,)), so decode masks every slot not yet written; S is
    ``seq_len``, or the window under a sliding window."""
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = tuple(lead) + (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(tuple(lead) + (S,), INT32_MAX, dtype=torch.int32,
                          device=device),
    }


def init_swiglu(gen, d_model, d_ff, dtype, device, lead=()):
    return {
        "norm": init_rmsnorm(d_model, dtype, device, lead),
        "w_gate": init_linear(gen, d_model, d_ff, dtype, device, False, lead),
        "w_up": init_linear(gen, d_model, d_ff, dtype, device, False, lead),
        "w_down": init_linear(gen, d_ff, d_model, dtype, device, False, lead),
    }


def swiglu_fwd(p, x, eps=1e-5):
    h = rmsnorm(p["norm"], x, eps)
    return x + linear(p["w_down"],
                      F.silu(linear(p["w_gate"], h)) * linear(p["w_up"], h))
