"""Decoder building blocks (counterpart of ``repro.models.layers``:
attention, cross-attention, latent attention, SwiGLU and MoE).  Params
are nested dicts of tensors in the reference's layouts: linear weights
(in, out), a leading ``lead`` axis on stacked block params.

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
position into the cache IN PLACE.  Latent attention (``mla_fwd``,
``mla_decode``) trains and prefills in the expanded form (per-head k, v
through flash) and decodes in the absorbed form (attention in the
latent space against the latent cache); cross-attention attends over
encoder embeddings whose k, v are computed once per prompt.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tp as TP
from repro_torch.models import flash
from repro_torch.models.flash import blockwise_attention  # noqa: F401


def _dense_init(gen: torch.Generator, shape: Sequence[int], dtype, device,
                scale: Optional[float] = None, lead: Sequence[int] = ()):
    """Normal(0, scale) with scale = 1/sqrt(fan_in) unless given, fan_in
    = shape[0] as the reference takes it (for an expert stack (E, D, F)
    that is E); ``lead`` prepends stacked-block axes (each slice is one
    block's weight).  A ``shape`` of more than two axes is drawn one
    trailing 2-D slice at a time straight into ``dtype``, so the f32
    transient is one slice, not the stack (one arctic expert leaf is
    128 x 7168 x 4864 a block)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    meta = torch.device(device).type == "meta"     # shapes only
    full = tuple(lead) + tuple(shape)
    if meta or len(shape) <= 2:
        w = torch.randn(full, device=device, generator=None if meta else gen,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)
    w = torch.empty(full, device=device, dtype=dtype)
    for part in w.view(-1, *shape[-2:]):
        part.copy_(torch.randn(shape[-2:], device=device, generator=gen,
                               dtype=torch.float32).mul_(scale))
    return w


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


def _col(p, h, tp=None):
    """A column-parallel linear (``h`` already through ``tp.copy``): a
    bias whole on every shard is cut to this shard's columns, its
    gradient summed over the model group."""
    w = p["w"]
    y = h @ w
    if "b" in p:
        b = p["b"]
        if b.shape[-1] != w.shape[-1]:
            b = tp.copy(b).narrow(-1, tp.m * w.shape[-1], w.shape[-1])
        y = y + b
    return y


def _row(p, x, tp=None):
    """A row-parallel linear: the partial products summed over the model
    group (``tp.reduce``), then the bias once."""
    y = x @ p["w"]
    if tp is not None:
        y = tp.reduce(y)
    if "b" in p:
        y = y + p["b"]
    return y


def split_heads(n_heads: int, tp) -> bool:
    """Whether ``n_heads`` heads do not divide over ``tp``'s model group,
    so a shard's column block of their (heads x head_dim) projection cuts
    a head (or, where the columns do not divide either, the projection
    is replicated): the reference's rules split the flattened columns
    however the model axis divides them."""
    return tp is not None and tp.mp > 1 and n_heads % tp.mp != 0


def head_slots(n_heads: int, tp):
    """This shard's heads: the same c = ceil(n_heads / mp) slots on every
    shard (an all-gather takes equal blocks), shard m's from head m·c, a
    slot past the last head repeating it (its output is computed and
    dropped); shard m's H/mp heads where they divide.  Returns the
    slots' head indices; with H < mp shards past the heads hold only
    repeats."""
    c = -(-n_heads // tp.mp)
    return [min(tp.m * c + j, n_heads - 1) for j in range(c)]


def _take(x, idx: Sequence[int], dim: int):
    """``x``'s entries ``idx`` of ``dim``: a narrow where they are a run."""
    if list(idx) == list(range(idx[0], idx[0] + len(idx))):
        return x.narrow(dim, idx[0], len(idx))
    return x.index_select(dim, torch.tensor(idx, device=x.device))


def _kv_heads_of(idx: Sequence[int], n_heads: int, n_kv: int):
    """The kv heads that query heads ``idx`` read (GQA: head j reads kv
    head j // (H / KH)): a run of whole groups keeps the grouping (each
    kv head once); any other set reads one kv head a query head (the kv
    heads repeated, MHA's layout)."""
    g = n_heads // n_kv
    lo, c = idx[0], len(idx)
    if list(idx) == list(range(lo, lo + c)) and lo % g == 0 and c % g == 0:
        return list(range(lo // g, (lo + c) // g))
    return [j // g for j in idx]


def _col_full(p, h, tp, width: int, mm=None):
    """All ``width`` columns of a column-parallel linear, on every shard
    (``h`` already through ``tp.copy``): a column shard's block gathered
    over ``model`` (``gather_dim``: each shard then reads its own heads of
    it, so the backward's reduce-scatter sums the shards' parts), or a
    weight the rules replicate (its columns do not divide) through
    ``copy``, so that its gradient, each shard's part, is summed over the
    group.  ``mm`` (default ``h @ w``, the bias added) multiplies."""
    w = p["w"]
    if w.shape[-1] != width:
        y = _col(p, h, tp) if mm is None else mm(h, w)
        return TP.gather_dim(y, tp.model, y.dim() - 1)
    w = tp.copy(w)
    y = h @ w if mm is None else mm(h, w)
    if "b" in p:
        y = y + tp.copy(p["b"])
    return y


def _heads_out(p, o, tp, n_heads: int):
    """The row-parallel output projection of this shard's query-head
    slots ``o`` (B, S, c, hd) when the heads are split mid-head: the slots
    gathered over ``model`` (``gather_dim``; the repeats past the last
    head dropped) to the flattened (heads x head_dim) layout, this
    shard's row block of ``wo`` applied (an even cut of a replicated
    ``wo``, through ``copy``) and the partial products summed."""
    B, S, _, hd = o.shape
    R = n_heads * hd
    full = TP.gather_dim(o, tp.model, 2)[:, :, :n_heads].reshape(B, S, R)
    w = p["w"]
    if w.shape[-2] != R:
        y = full.narrow(-1, tp.m * w.shape[-2], w.shape[-2]) @ w
    else:
        lo, hi = tp.m * R // tp.mp, (tp.m + 1) * R // tp.mp
        y = full[..., lo:hi] @ tp.copy(w)[lo:hi]
    y = tp.reduce(y)
    if "b" in p:
        y = y + p["b"]
    return y


def _queries(p, cfg: ModelConfig, h, tp):
    """(q (B, S, c, hd), its heads): this shard's query heads, a column
    shard's own when the heads divide (or no ``tp``), else the slots of
    :func:`head_slots` out of the whole projection."""
    B, S, _ = h.shape
    hd, H = cfg.head_dim, cfg.n_heads
    if not split_heads(H, tp):
        q = _col(p["wq"], h, tp).view(B, S, -1, hd)
        lo = tp.m * q.shape[2] if tp is not None else 0
        return q, list(range(lo, lo + q.shape[2]))
    idx = head_slots(H, tp)
    q = _col_full(p["wq"], h, tp, H * hd).view(B, S, H, hd)
    return _take(q, idx, 2), idx


def attention_fwd(p, cfg: ModelConfig, x, positions, tp=None):
    """Pre-norm self-attention with residual, for training and prefill.
    x: (B, S, D).  Returns (x + attention, (k, v)): the roped keys and the
    values, (B, S, KH, hd) each, which prefill keeps as the cache.

    Under tensor parallelism (``tp``, a ``dist.tp.Shards``) ``wq``,
    ``wk``, ``wv`` are column shards and ``wo`` a row shard, its products
    summed over the model group.  Where the kv heads divide over the
    shards, so do the query heads: each shard attends its own whole heads
    (query heads [m·H/mp, (m+1)·H/mp) meet their kv heads [m·KH/mp, ...),
    GQA's contiguous grouping), and k, v are this shard's.  Else (a
    shard's block cuts a kv head) k and v are gathered whole on every
    shard (:func:`_col_full`) and returned whole, as the reference's cache
    rule then holds them; the query heads stay the shard's own where they
    divide, else each shard attends the slots of :func:`head_slots` and
    the outputs are gathered before ``wo``'s row block
    (:func:`_heads_out`).  Rope runs on whole heads."""
    B, S, _ = x.shape
    hd, H, KH = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps)
    if tp is not None:
        h = tp.copy(h)
    q, idx = _queries(p, cfg, h, tp)
    if split_heads(KH, tp):
        k = _col_full(p["wk"], h, tp, KH * hd).view(B, S, KH, hd)
        v = _col_full(p["wv"], h, tp, KH * hd).view(B, S, KH, hd)
    else:
        k = _col(p["wk"], h, tp).view(B, S, -1, hd)
        v = _col(p["wv"], h, tp).view(B, S, -1, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ks, vs = k, v
    if split_heads(KH, tp):
        kv = _kv_heads_of(idx, H, KH)
        ks, vs = _take(k, kv, 2), _take(v, kv, 2)
    o = flash.flash_attention(q, ks, vs, True, cfg.sliding_window)
    return x + _attn_out(p["wo"], o, tp, H), (k, v)


def _attn_out(p, o, tp, n_heads: int):
    """``wo`` on this shard's heads' output o (B, S, c, hd)."""
    if split_heads(n_heads, tp):
        return _heads_out(p, o, tp, n_heads)
    return _row(p, o.reshape(o.shape[0], o.shape[1], -1), tp)


def decode_attention(q, k_cache, v_cache, *, kv_positions, pos: int,
                     window: int = 0, seq=None):
    """Single-token attention against a (possibly only partially valid)
    cache.  q: (B, 1, H, D); caches: (B, S, KH, D); kv_positions: (S,)
    absolute positions held by each cache slot; pos: the current
    position.  Slots with kv_positions > pos (unwritten: the int32-max
    sentinel) are masked, and under a window those pos - window or
    older.  Scores and softmax in f32; returns (B, 1, H, D) in q's
    dtype.  ``seq``: the group over which the cache is split along the
    sequence; each member's partial softmax is combined (the max
    all-reduced, then the sums of exponentials and of weighted values)."""
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    qr = q.reshape(B, KH, H // KH, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    valid = kv_positions <= pos
    if window:
        valid &= pos - kv_positions < window
    s = s.masked_fill(~valid, float("-inf"))
    if seq is not None:
        mx = TP.all_reduce_max(s.amax(-1, keepdim=True), seq)
        e = torch.exp(s - mx)
        num = seq.all_reduce(torch.einsum("bhgk,bkhd->bhgd", e,
                                          v_cache.float()))
        o = num / seq.all_reduce(e.sum(-1, keepdim=True))
        return o.reshape(B, 1, H, D).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def _slot(S: int, pos: int, seq, ring: bool = False):
    """The cache slot of position ``pos`` in this member's S slots (of
    S·n split along the sequence over ``seq``; -1 when another member
    holds it); raises past the cache.  With ``ring`` (a sliding window)
    the S·n slots are a ring buffer: ``pos`` goes to slot pos % (S·n)."""
    n, i = (seq.size, seq.index) if seq is not None else (1, 0)
    if ring:
        pos = pos % (S * n)
    elif not 0 <= pos < S * n:
        raise IndexError(f"decode position {pos} is past the cache's "
                         f"{S * n} slots")
    slot = pos - i * S
    return slot if 0 <= slot < S else -1


def attention_decode(p, cfg: ModelConfig, x, cache, pos: int, tp=None,
                     seq=None):
    """x: (B, 1, D); cache: {"k", "v": (B, S, KH, hd), "pos": (S,) int32
    absolute positions}.  The token's k, v and position go into slot
    ``pos`` (``pos % S`` under a sliding window: a ring buffer) IN PLACE.
    Returns (x + attention, cache).  ``tp``: as in :func:`attention_fwd`:
    the cache holds this shard's kv heads where they divide over the
    shards, else all KH of them (the reference's cache rule), the new
    token's k, v gathered whole into it and this shard's query heads
    attending the kv heads they read; ``seq``: the cache is split along
    the sequence over this group, member i holding slots [i·S, (i+1)·S)
    of the S·n (under a sliding window the ring's, ``pos`` going to
    slot pos % (S·n)), and the member holding ``pos``'s slot writes
    it."""
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps)
    q, idx = _queries(p, cfg, h, tp)
    if split_heads(KH, tp):
        k = _col_full(p["wk"], h, tp, KH * hd).view(B, 1, KH, hd)
        v = _col_full(p["wv"], h, tp, KH * hd).view(B, 1, KH, hd)
    else:
        k = _col(p["wk"], h, tp).view(B, 1, -1, hd)
        v = _col(p["wv"], h, tp).view(B, 1, -1, hd)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    slot = _slot(cache["k"].shape[1], pos, seq,
                 ring=bool(cfg.sliding_window))
    if slot >= 0:
        cache["k"][:, slot].copy_(k[:, 0])
        cache["v"][:, slot].copy_(v[:, 0])
        cache["pos"][slot:slot + 1].fill_(pos)     # no host-to-device copy
    kc, vc = cache["k"], cache["v"]
    if split_heads(KH, tp):
        kv = _kv_heads_of(idx, H, KH)
        kc, vc = _take(kc, kv, 2), _take(vc, kv, 2)
    o = decode_attention(q, kc, vc, kv_positions=cache["pos"], pos=pos,
                         window=cfg.sliding_window, seq=seq)
    return x + _attn_out(p["wo"], o, tp, H), cache


INT32_MAX = 2 ** 31 - 1       # a cache slot's position before it is written


def init_attention_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                         device, lead=(), kv_heads: int = 0):
    """Zero k, v (lead + (B, S, KH, hd)) and int32-max positions
    (lead + (S,)), so decode masks every slot not yet written; S is
    ``seq_len``, or the window under a sliding window; KH is
    ``kv_heads`` (a model shard's) or ``cfg.n_kv_heads``."""
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = tuple(lead) + (batch, S, kv_heads or cfg.n_kv_heads,
                           cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(tuple(lead) + (S,), INT32_MAX, dtype=torch.int32,
                          device=device),
    }


def _promoted_linear(p, x):
    """x @ w in the promoted dtype of the two, as jnp's ``@`` computes
    it (f32 embeddings against bf16 weights give f32; PyTorch's ``@``
    refuses mixed dtypes)."""
    dt = torch.promote_types(x.dtype, p["w"].dtype)
    return x.to(dt) @ p["w"].to(dt)


# ---------------------------------------------------------------------------
# cross-attention: queries from the text, keys and values from the
# encoder's embeddings


def init_cross_attention(gen, cfg: ModelConfig, dtype, device, lead=()):
    """The reference's tree, with its tanh gate at 0: at init the layer
    adds exactly nothing, and its projections' gradients are 0."""
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "norm": init_rmsnorm(D, dtype, device, lead),
        "wq": init_linear(gen, D, H * hd, dtype, device, False, lead),
        "wk": init_linear(gen, cfg.encoder_dim, KH * hd, dtype, device,
                          False, lead),
        "wv": init_linear(gen, cfg.encoder_dim, KH * hd, dtype, device,
                          False, lead),
        "wo": init_linear(gen, H * hd, D, dtype, device, False, lead),
        "gate": torch.zeros(tuple(lead) + (1,), dtype=dtype, device=device),
    }


def cross_attention_kv(p, cfg: ModelConfig, enc, tp=None):
    """enc: (B, T, encoder_dim) -> k, v (B, T, KH, hd), once a prompt, in
    the promoted dtype of enc and the weights: f32 for the f32
    embeddings of the data stream and of serving, as in the reference.
    Under tensor parallelism ``wk``, ``wv`` are column shards: where the
    kv heads divide over the shards k, v hold this shard's KH/mp heads,
    else they are gathered whole on every shard (:func:`_col_full`), as
    the reference's cache rule then holds the cross cache."""
    B, T, _ = enc.shape
    if tp is not None:
        enc = tp.copy(enc)
    hd, KH = cfg.head_dim, cfg.n_kv_heads
    if split_heads(KH, tp):
        def mm(a, w):
            return _promoted_linear({"w": w}, a)
        k = _col_full(p["wk"], enc, tp, KH * hd, mm)
        v = _col_full(p["wv"], enc, tp, KH * hd, mm)
    else:
        k = _promoted_linear(p["wk"], enc)
        v = _promoted_linear(p["wv"], enc)
    return k.view(B, T, -1, hd), v.view(B, T, -1, hd)


def cross_attention_fwd(p, cfg: ModelConfig, x, enc_kv, tp=None, seq=None):
    """Pre-norm cross-attention with a tanh gate and residual: every
    query sees every encoder token (non-causal flash; a T past 1024 that
    the reference's rule would cut into 1-key chunks pads instead, the
    padded keys masked by index).  The output is in x's dtype.  ``tp``:
    ``wq`` a column shard and ``wo`` a row shard as in
    :func:`attention_fwd`: this shard's query heads (its own whole heads,
    or the slots of :func:`head_slots` where the query heads are split
    mid-head) read their kv heads in ``enc_kv`` (this shard's whole kv
    heads, or all of them when :func:`cross_attention_kv` gathered
    them); ``seq``: a decode step's cached k, v hold this member's block
    of the encoder tokens, the partial softmaxes combined over that
    group."""
    B, S, _ = x.shape
    H, KH = cfg.n_heads, cfg.n_kv_heads
    k, v = enc_kv
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps)
    if tp is not None:
        h = tp.copy(h)
    q, idx = _queries(p, cfg, h, tp)
    if split_heads(KH, tp):
        kv = _kv_heads_of(idx, H, KH)
        k, v = _take(k, kv, 2), _take(v, kv, 2)
    if seq is None:
        o = flash.flash_attention(q, k, v, False, 0)
    else:
        o = decode_attention(q, k, v, kv_positions=torch.zeros(
            k.shape[1], dtype=torch.int32, device=x.device), pos=0, seq=seq)
    gate = torch.tanh(p["gate"].float()).to(x.dtype)
    return x + gate * _attn_out(p["wo"], o, tp, H)


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V3's multi-head latent attention


def init_mla(gen, cfg: ModelConfig, dtype, device, lead=()):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "norm": init_rmsnorm(D, dtype, device, lead),
        "wq_a": init_linear(gen, D, m.q_lora_rank, dtype, device, False,
                            lead),
        "q_norm": init_rmsnorm(m.q_lora_rank, dtype, device, lead),
        "wq_b": init_linear(gen, m.q_lora_rank, H * qk, dtype, device, False,
                            lead),
        "wkv_a": init_linear(gen, D, m.kv_lora_rank + m.qk_rope_head_dim,
                             dtype, device, False, lead),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dtype, device, lead),
        "wkv_b": init_linear(gen, m.kv_lora_rank,
                             H * (m.qk_nope_head_dim + m.v_head_dim), dtype,
                             device, False, lead),
        "wo": init_linear(gen, H * m.v_head_dim, D, dtype, device, False,
                          lead),
    }


def _latent(p, h, hc, width: int, tp):
    """A latent projection every shard then reads alike: a column shard
    of ``hc`` (``h`` through ``copy``) gathered, or a weight the rules
    replicate applied to ``h`` itself (its gradient whole on every
    shard, so not summed again through ``copy``)."""
    if p["w"].shape[-1] == width:
        return linear(p, h)
    return tp.gather(linear(p, hc))


def _mla_qkv(p, cfg: ModelConfig, h, positions, tp=None):
    """h: (B, S, D), normed.  Returns q_nope (B, S, c, nope), q_rope (B,
    S, c, rope) roped, the latent c_kv (B, S, r) after kv_norm, k_rope
    (B, S, 1, rope) roped, and the c query heads' indices.  Under tensor
    parallelism ``wq_a`` and ``wkv_a`` are column shards of their (not
    head-aligned) latent dims, gathered before the norms and the rope
    split (every shard then holds the whole c_kv and k_rope).  Where the
    heads divide over the shards ``wq_b`` is a column shard of whole
    heads and q holds this shard's H/mp of them; else (its columns cut a
    head, or do not divide and the rules replicate it) q is taken whole
    (:func:`_col_full`) and this shard keeps the slots of
    :func:`head_slots`."""
    m = cfg.mla
    B, S, _ = h.shape
    H, qk = cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim
    hc = h if tp is None else tp.copy(h)
    qa = _latent(p["wq_a"], h, hc, m.q_lora_rank, tp)
    qa = rmsnorm(p["q_norm"], qa, cfg.rms_norm_eps)
    if tp is not None:
        qa = tp.copy(qa)
    if split_heads(H, tp):
        idx = head_slots(H, tp)
        q = _take(_col_full(p["wq_b"], qa, tp, H * qk).view(B, S, H, qk),
                  idx, 2)
    else:
        q = linear(p["wq_b"], qa).view(B, S, -1, qk)
        lo = tp.m * q.shape[2] if tp is not None else 0
        idx = list(range(lo, lo + q.shape[2]))
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = _latent(p["wkv_a"], h, hc, m.kv_lora_rank + m.qk_rope_head_dim,
                   tp)
    c_kv, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = rmsnorm(p["kv_norm"], c_kv, cfg.rms_norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope, idx


def _mla_expand_kv(p, cfg: ModelConfig, c_kv, k_rope, tp=None, idx=None):
    """The latent expanded to per-head k (B, S, c, nope + rope; the rope
    key shared by every head) and v (B, S, c, v_head_dim) of the query
    heads ``idx``: ``wkv_b``'s own heads (all of them, or a shard's
    whole heads under tensor parallelism), or, where the model shards
    cut a head, the slots ``idx`` of the whole expansion
    (:func:`_col_full`; ``c_kv`` already through ``copy``)."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    w = m.qk_nope_head_dim + m.v_head_dim
    if split_heads(cfg.n_heads, tp):
        kv = _take(_col_full(p["wkv_b"], c_kv, tp, cfg.n_heads * w).view(
            B, S, cfg.n_heads, w), idx, 2)
    else:
        kv = linear(p["wkv_b"], c_kv).view(B, S, -1, w)
    H = kv.shape[2]
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)], -1)
    return k, v.contiguous()


def mla_fwd(p, cfg: ModelConfig, x, positions, tp=None):
    """Latent attention with residual, for training and prefill, in the
    expanded form: causal flash over q, k of width nope + rope and v of
    width v_head_dim.  Returns (x + attention, (c_kv (B, S, r), k_rope
    (B, S, rope))): what prefill keeps as the cache.  ``tp``: each shard
    attends with its query heads (``_mla_qkv``: its whole heads, or the
    slots of :func:`head_slots` where the shards cut a head), k and v
    expanded for those heads from ``wkv_b`` (the gathered latent and rope
    key through ``copy`` first), and ``wo`` takes the outputs as
    ``attention_fwd``'s does (a row shard of whole heads, or the slots
    gathered first, :func:`_heads_out`); the returned latent is whole."""
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps)
    q_nope, q_rope, c_kv, k_rope, idx = _mla_qkv(p, cfg, h, positions, tp)
    if tp is not None:
        k, v = _mla_expand_kv(p, cfg, tp.copy(c_kv), tp.copy(k_rope), tp,
                              idx)
    else:
        k, v = _mla_expand_kv(p, cfg, c_kv, k_rope)
    q = torch.cat([q_nope, q_rope], -1)
    o = flash.flash_attention(q, k, v, True, 0)
    return x + _attn_out(p["wo"], o, tp, cfg.n_heads), \
        (c_kv, k_rope[:, :, 0])


def _wkv_b_heads(p, cfg: ModelConfig, tp, idx):
    """``wkv_b`` as (r, c, nope + v) for the query heads ``idx``: a
    shard's own whole heads, or, where the shards cut a head, the slots
    ``idx`` of the whole weight (a column shard's blocks gathered over
    ``model``; decode only, no gradient)."""
    m = cfg.mla
    w = p["wkv_b"]["w"]
    width = m.qk_nope_head_dim + m.v_head_dim
    if not split_heads(cfg.n_heads, tp):
        return w.view(m.kv_lora_rank, -1, width)
    if w.shape[-1] != cfg.n_heads * width:
        w = tp.model.all_gather(w, -1)
    return _take(w.view(m.kv_lora_rank, cfg.n_heads, width), idx, 1)


def mla_decode(p, cfg: ModelConfig, x, cache, pos: int, tp=None, seq=None):
    """One token against the latent cache, in the absorbed form (the
    reference's): q_nope is lifted into the latent space by wkv_b's key
    half (in the model dtype), the scores are two products with f32
    results (the reference's ``preferred_element_type``) times
    1/sqrt(nope + rope), the softmax runs over the slots with kv_pos <=
    pos, the latent output is f32 against the f32 latent and is cast to
    the model dtype before wkv_b's value half.  Equal to the expanded
    form up to rounding.  x: (B, 1, D); cache: {"c_kv": (B, S, r),
    "k_rope": (B, S, rope), "pos": (S,) int32}, written at slot ``pos``
    IN PLACE.  Returns (x + attention, cache).

    ``tp``: each shard lifts its query heads (its whole heads, or the
    slots of :func:`head_slots` where the shards cut a head) with
    ``wkv_b``'s key half of those heads, and q_lat and q_rope are
    gathered over the heads (the repeats past the last head dropped).
    The cache holds the latent and the rope key whole, or this shard's
    block of their last dim where the reference's rule splits it over
    ``model`` (it divides): the scores of a split part are summed over
    ``model``, a whole part's computed on every shard alike; the latent
    output's blocks are gathered before this shard's heads take wkv_b's
    value half, and ``wo`` takes the outputs as in :func:`mla_fwd`.
    ``seq``: the cache holds this member's slots along the sequence, the
    partial softmaxes combined over that group (as ``decode_attention``
    does)."""
    m = cfg.mla
    B, H = x.shape[0], cfg.n_heads
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, k_rope_new, idx = _mla_qkv(p, cfg, h, posv, tp)
    r, e = cache["c_kv"].shape[-1], cache["k_rope"].shape[-1]
    r_split, e_split = r != m.kv_lora_rank, e != m.qk_rope_head_dim
    if r_split:
        c_new = c_new.narrow(-1, tp.m * r, r)
    if e_split:
        k_rope_new = k_rope_new.narrow(-1, tp.m * e, e)
    slot = _slot(cache["c_kv"].shape[1], pos, seq)
    if slot >= 0:
        cache["c_kv"][:, slot].copy_(c_new[:, 0])
        cache["k_rope"][:, slot].copy_(k_rope_new[:, 0, 0])
        cache["pos"][slot:slot + 1].fill_(pos)
    wk_b, wv_b = _wkv_b_heads(p, cfg, tp, idx).split(
        [m.qk_nope_head_dim, m.v_head_dim], -1)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wk_b)       # (B, 1, c, r)
    if tp is not None and tp.mp > 1:
        q_lat = tp.model.all_gather(q_lat, 2)[:, :, :H]
        q_rope = tp.model.all_gather(q_rope, 2)[:, :, :H]
    if r_split:
        q_lat = q_lat.narrow(-1, tp.m * r, r)
    if e_split:
        q_rope = q_rope.narrow(-1, tp.m * e, e)
    c_kv = cache["c_kv"].float()
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s_lat = torch.einsum("bqhr,bkr->bhk", q_lat.float(), c_kv)
    s_rope = torch.einsum("bqhe,bke->bhk", q_rope.float(),
                          cache["k_rope"].float())
    if r_split and e_split:
        s = tp.model.all_reduce(s_lat + s_rope)
    elif r_split:
        s = tp.model.all_reduce(s_lat) + s_rope
    elif e_split:
        s = s_lat + tp.model.all_reduce(s_rope)
    else:
        s = s_lat + s_rope
    s = (s * scale).masked_fill(~(cache["pos"] <= pos), float("-inf"))
    if seq is None:
        o_lat = torch.einsum("bhk,bkr->bhr", torch.softmax(s, dim=-1), c_kv)
    else:
        mx = TP.all_reduce_max(s.amax(-1, keepdim=True), seq)
        ex = torch.exp(s - mx)
        o_lat = seq.all_reduce(torch.einsum("bhk,bkr->bhr", ex, c_kv)) \
            / seq.all_reduce(ex.sum(-1, keepdim=True))
    if r_split:
        o_lat = tp.model.all_gather(o_lat, -1)                # (B, H, r)
    o_lat = _take(o_lat, idx, 1)                              # (B, c, r)
    o = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), wv_b)
    return x + _attn_out(p["wo"], o[:, None], tp, H), cache


def init_mla_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                   device, lead=()):
    """Zero latents c_kv (lead + (B, S, r)) and rope keys (lead + (B, S,
    rope)), int32-max positions (lead + (S,))."""
    m = cfg.mla
    shape = tuple(lead) + (batch, seq_len)
    return {
        "c_kv": torch.zeros(shape + (m.kv_lora_rank,), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros(shape + (m.qk_rope_head_dim,), dtype=dtype,
                              device=device),
        "pos": torch.full(tuple(lead) + (seq_len,), INT32_MAX,
                          dtype=torch.int32, device=device),
    }


def init_swiglu(gen, d_model, d_ff, dtype, device, lead=()):
    return {
        "norm": init_rmsnorm(d_model, dtype, device, lead),
        "w_gate": init_linear(gen, d_model, d_ff, dtype, device, False, lead),
        "w_up": init_linear(gen, d_model, d_ff, dtype, device, False, lead),
        "w_down": init_linear(gen, d_ff, d_model, dtype, device, False, lead),
    }


def swiglu_fwd(p, x, eps=1e-5, residual=True, tp=None, reduce=True):
    """Pre-norm SwiGLU.  Under tensor parallelism (``tp``) ``w_gate`` and
    ``w_up`` are column shards and ``w_down`` a row shard; its products
    are summed over the model group before the residual is added (left
    as this shard's part when not ``reduce``)."""
    h = rmsnorm(p["norm"], x, eps)
    if tp is not None:
        h = tp.copy(h)
        y = _row(p["w_down"], F.silu(_col(p["w_gate"], h, tp))
                 * _col(p["w_up"], h, tp), tp if reduce else None)
        return x + y if residual else y
    y = linear(p["w_down"],
               F.silu(linear(p["w_gate"], h)) * linear(p["w_up"], h))
    return x + y if residual else y


# ---------------------------------------------------------------------------
# MoE: token-choice top-k routing, per-expert capacity by top-C selection

MOE_DISPATCH_GROUPS = 32   # the reference's, aligned with its dp width


def init_moe(gen, cfg: ModelConfig, dtype, device, lead=()):
    """Router (f32), the experts' stacked SwiGLU weights (E, D, F) and (E,
    F, D), and the shared experts' and Arctic's dense residual SwiGLUs.
    The expert stacks draw with the reference's scale 1/sqrt(E) (its
    ``_dense_init`` takes fan_in = shape[0] = E), not 1/sqrt(D)."""
    mo = cfg.moe
    D, E, F_ = cfg.d_model, mo.num_experts, mo.d_ff_expert
    p = {
        "norm": init_rmsnorm(D, dtype, device, lead),
        "router": init_linear(gen, D, E, torch.float32, device, lead=lead),
        "w_gate": _dense_init(gen, (E, D, F_), dtype, device, lead=lead),
        "w_up": _dense_init(gen, (E, D, F_), dtype, device, lead=lead),
        "w_down": _dense_init(gen, (E, F_, D), dtype, device, lead=lead),
    }
    if mo.num_shared_experts:
        p["shared"] = init_swiglu(gen, D, F_ * mo.num_shared_experts, dtype,
                                  device, lead)
    if mo.dense_residual_d_ff:
        p["dense_residual"] = init_swiglu(gen, D, mo.dense_residual_d_ff,
                                          dtype, device, lead)
    return p


def topk_lowest_first(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis of x >= 0: the k largest values,
    the lower index first among equal ones (``torch.topk`` keeps no tie
    order on either device).  Selects on unique int64 keys: the value's
    bits (monotone in x for x >= 0), then the index ascending.  Returns
    (values, int64 indices)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    key = (x.detach().contiguous().view(torch.int32) & 0x7FFFFFFF).to(
        torch.int64) * n + (n - 1 - idx)
    sel = key.topk(k, dim=-1).indices
    return x.gather(-1, sel), sel


def moe_group_size(T: int, E: int, dropless: bool = False) -> int:
    """Tokens a dispatch group, the reference's rule over T tokens: T /
    MOE_DISPATCH_GROUPS, or T (one group) when ``dropless``, when T % G
    or when T // G < E."""
    G = MOE_DISPATCH_GROUPS
    if dropless or T % G or T // G < E:
        G = 1
    return T // G


def moe_capacity(Tg: int, mo, dropless: bool = False) -> int:
    """Each expert's slots a group: Tg·K/E·cf (Python floats), at least
    1 and at most Tg; Tg when ``dropless``."""
    if dropless:
        return Tg
    return min(max(1, int(Tg * mo.top_k / mo.num_experts
                          * mo.capacity_factor)), Tg)


def moe_gates(probs, K: int):
    """Each token's top-K experts by prob, their probs normalised into
    gates (T, E) f32, zero elsewhere."""
    T, E = probs.shape
    topk_p, topk_i = topk_lowest_first(probs, K)              # (T, K)
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)
    return torch.zeros((T, E), dtype=torch.float32,
                       device=probs.device).scatter(1, topk_i, topk_p)


def moe_route(probs, mo, dropless: bool = False):
    """The router's choice and the experts' capacity selection over one
    process's T tokens, as ``moe_fwd`` runs them: :func:`moe_gates`, then
    :func:`moe_dispatch`.  probs: (T, E) f32.  Returns (gates, gsel (G, E,
    C), tok_idx (G, E, C) group-local); a slot with gsel = 0 holds no
    token."""
    gates = moe_gates(probs, mo.top_k)
    gsel, rows = moe_dispatch(gates, mo, dropless)
    Tg = probs.shape[0] // gsel.shape[0]
    return gates, gsel, rows - torch.arange(
        gsel.shape[0], device=rows.device)[:, None, None] * Tg


def moe_dispatch(gates, mo, dropless: bool = False, batch=None):
    """Each expert's top-C tokens per dispatch group of the whole batch.
    gates: (T, E_l) f32, some experts' columns of this member's T tokens;
    ``batch`` (a ``dist.tp.Group`` of n members, member i holding the
    whole batch's tokens [i·T, (i+1)·T)) or None (n = 1).  The groups are
    the reference's over the n·T tokens (:func:`moe_group_size`, with
    cfg's E): when whole groups lie in this member, it selects in them
    alone; else (a group spans members) on the gathered gates, keeping
    the slots of its own tokens.  ``dropless`` selects locally: the one
    group keeps every token, so this member's tokens are its own group's.
    Returns (gsel (G, E_l, C), rows (G, E_l, C)): the gate of each slot
    (0 = no token of this member) and its token's row in this member's
    T."""
    T, El = gates.shape
    n = batch.size if batch is not None and not dropless else 1
    Tg = moe_group_size(T * n, mo.num_experts, dropless)
    C = moe_capacity(Tg, mo, dropless)
    if T % Tg == 0:
        G = T // Tg
        gsel, idx = topk_lowest_first(gates.view(G, Tg, El).transpose(1, 2),
                                      C)                      # (G, E_l, C)
        return gsel, idx + torch.arange(G, device=gates.device)[
            :, None, None] * Tg
    G = T * n // Tg
    _, idx = topk_lowest_first(batch.all_gather(gates.detach(), 0).view(
        G, Tg, El).transpose(1, 2), C)
    glob = idx + torch.arange(G, device=gates.device)[:, None, None] * Tg
    lo = batch.index * T
    mine = (glob >= lo) & (glob < lo + T)
    rows = (glob - lo).clamp(0, T - 1)
    gsel = gates.t().gather(1, rows.transpose(0, 1).reshape(El, -1))
    gsel = gsel.view(El, G, C).transpose(0, 1)
    return torch.where(mine, gsel, 0.0), rows


def moe_fwd(p, cfg: ModelConfig, x, dropless: bool = False, tp=None,
            whole_aux: bool = True):
    """Token-choice top-k routing with grouped per-expert capacity (the
    reference's ``moe_fwd``): tokens split into G dispatch groups, each
    expert takes its top-C tokens per group by gate, C = Tg·K/E·cf
    (Python floats).  G = 1 when ``dropless`` (then C = Tg: no token is
    dropped), when T % G or when T // G < E.  Returns (x + out, the
    router's load-balance aux loss).

    ``tp`` (a ``dist.tp.Shards``): with ``tp.batch`` the batch is split
    over that group and the groups and the aux loss's means are the
    whole batch's (:func:`moe_dispatch`; the per-expert sums all-reduced,
    the aux the same on every member; with ``whole_aux`` False, for a
    caller that throws the aux away, its means are this member's and its
    all-reduces are saved); with the experts split over
    ``tp.model`` (expert parallelism: the router's columns and the
    expert stacks hold this shard's E/mp experts) the router's logits
    are gathered (every shard routes every token alike), each shard
    runs its own experts' capacity selection and scatter-add, and their
    outputs are summed over the model group with the shared and dense
    residual SwiGLUs' row-parallel parts, in one all-reduce."""
    mo = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = mo.num_experts, mo.top_k
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps).reshape(T, D)
    batch = tp.batch if tp is not None and tp.nb > 1 else None
    ep = tp if tp is not None and tp.mp > 1 \
        and p["w_gate"].shape[-3] != E else None
    hc = h if ep is None else ep.copy(h)

    logits = linear(p["router"], hc.float())
    if ep is not None:
        logits = ep.gather(logits)
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gates = moe_gates(probs, K)
    mine = gates
    if ep is not None:
        El = p["w_gate"].shape[-3]
        # the whole gates through copy: each shard's expert columns get
        # their gradient there alone, summed whole on every shard
        mine = ep.copy(gates).narrow(1, ep.m * El, El)
    gsel, rows = moe_dispatch(mine, mo, dropless, batch)
    G, El, C = gsel.shape
    valid = gsel > 0.0
    rows = rows.transpose(0, 1).reshape(El, G * C)            # (E, G·C)
    xe = hc[rows]                                             # (E, G·C, D)
    act = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    yo = torch.bmm(act, p["w_down"])                          # (E, G·C, D)
    w = (gsel * valid).to(yo.dtype).transpose(0, 1).reshape(El, G * C, 1)
    out = torch.zeros((T, D), dtype=yo.dtype, device=x.device)
    if tp is not None and tp.mp > 1 and ep is None:
        # every model shard computes every expert and must agree:
        # index_put's accumulate sums each row's slots in their order on
        # the card too; index_add's atomics there do not (three ranks
        # served bf16 tokens that differed)
        out = out.index_put((rows.reshape(-1),),
                            (yo * w).reshape(El * G * C, D), accumulate=True)
    else:
        out = out.index_add(0, rows.reshape(-1),
                            (yo * w).reshape(El * G * C, D))

    # load-balance aux loss (Switch-style), in the reference's order
    if batch is None or not whole_aux:
        me = probs.mean(0)                                    # (E,)
        ce = (gates > 0).float().mean(0) * E / K
    else:
        n_all = T * batch.size
        me = TP.sum_over(probs.sum(0), batch) / n_all
        ce = batch.all_reduce((gates > 0).float().sum(0)) / n_all * E / K
    aux = mo.aux_loss_coef * E * torch.sum(me * ce) / E

    # the shared experts and arctic's dense residual: a column-split one's
    # row-parallel part joins the experts' parts in their one all-reduce
    # (its own when the experts are whole), a whole one is added after
    tpm = tp if tp is not None and tp.mp > 1 else None
    widths = {"shared": mo.d_ff_expert * mo.num_shared_experts,
              "dense_residual": mo.dense_residual_d_ff}
    late = []
    for name in ("shared", "dense_residual"):
        if name not in p:
            continue
        split = tpm is not None and \
            p[name]["w_gate"]["w"].shape[-1] != widths[name]
        y = swiglu_fwd(p[name], h, cfg.rms_norm_eps, residual=False,
                       tp=tpm if split else None,
                       reduce=ep is None)
        if ep is not None and not split:
            late.append(y)
        else:
            out = out + y
    if ep is not None:
        out = ep.reduce(out)
    for y in late:
        out = out + y
    return x + out.reshape(B, S, D).to(x.dtype), aux
