"""Mamba2 SSD (state-space duality) block [arXiv:2405.21060]; counterpart
of ``repro.models.mamba2``, plain PyTorch as the reference's is plain jnp.

Chunked SSD: the sequence is split into chunks of Q rows; within a chunk
the output is a masked quadratic, attention-like product, and across
chunks a first-order recurrence carries the (H, N, P) state, one chunk
at a time (the reference's ``lax.scan``), so one chunk's (Q, Q, H) tensor
is live at a time.  Decode is the O(1)-state recurrent update.

Head layout as the paper's: d_inner = expand·d_model split into H heads
of P; B and C are shared by the heads (one group); A is a per-head
scalar decay, dt a per-head per-token step.

The chunk rule differs from the reference's where the reference's would
collapse (:func:`chunk_plan`): it halves Q until Q divides S, which at S
= 4097 or 32769 gives 1-row chunks, one loop step per token.  The port
keeps that Q where it is at least min(chunk, 64) rows or the whole
length, and otherwise pads x, dt, B and C at the end to a multiple of
the chunk and drops the padded rows: exact, because SSD is causal.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models.layers import (_dense_init, _take, head_slots,
                                       init_linear, init_rmsnorm, linear,
                                       rmsnorm)


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return s, d_inner, n_heads


def init_mamba(gen, cfg: ModelConfig, dtype, device, lead=()):
    """The reference's leaves: in_proj to [z, x, B, C, dt], the depthwise
    conv, A_log = log(A) with A ~ U[1, 16] per head, dt_bias, the D skip
    (f32 each), the gated output norm and out_proj."""
    s, d_inner, H = _dims(cfg)
    N = s.d_state
    d_in_proj = 2 * d_inner + 2 * N + H
    conv_dim = d_inner + 2 * N
    lead = tuple(lead)
    meta = torch.device(device).type == "meta"
    u = torch.rand(lead + (H,), device=device,
                   generator=None if meta else gen, dtype=torch.float32)
    A = torch.exp(u * math.log(16.0))              # log A ~ U[log 1, log 16]
    return {
        "norm": init_rmsnorm(cfg.d_model, dtype, device, lead),
        "in_proj": init_linear(gen, cfg.d_model, d_in_proj, dtype, device,
                               lead=lead),
        "conv_w": _dense_init(gen, (s.d_conv, conv_dim), dtype, device,
                              scale=0.1, lead=lead),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(A),                                  # (H,) f32
        "dt_bias": torch.zeros(lead + (H,), dtype=torch.float32,
                               device=device),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=device),
        "out_norm": init_rmsnorm(d_inner, dtype, device, lead),
        "out_proj": init_linear(gen, d_inner, cfg.d_model, dtype, device,
                                lead=lead),
    }


def _split_in_proj(cfg: ModelConfig, zxbcdt):
    s, d_inner, H = _dims(cfg)
    N = s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)


def softplus(x):
    """``jax.nn.softplus`` (logaddexp(x, 0)): max(x, 0) + log1p(exp(-|x|)),
    with no threshold (``F.softplus`` returns x itself above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(w, b, xBC, conv_state=None):
    """Depthwise causal conv1d + SiLU.  xBC: (B, S, C); w: (K, C);
    conv_state (B, K-1, C), if given, is prepended (decode).  Returns (out,
    the padded input's last K-1 rows: the pre-activation conv state)."""
    K = w.shape[0]
    pad = (torch.zeros_like(xBC[:, :1]).expand(-1, K - 1, -1)
           if conv_state is None else conv_state)
    xp = torch.cat([pad, xBC], dim=1)                       # (B, S+K-1, C)
    L = xp.shape[1]
    out = 0
    for i in range(K):                  # the reference's sum(), in order
        out = out + xp[:, i:L - (K - 1 - i)] * w[i]
    return F.silu(out + b), xp[:, L - (K - 1):]


def chunk_plan(S: int, chunk: int) -> Tuple[int, int]:
    """(Q, padded length): the reference's Q (halved from min(chunk, S)
    until it divides S) where that is at least min(chunk, 64) rows or the
    whole length, else Q = chunk with S padded up to a multiple of it."""
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    if Q >= min(chunk, 64) or Q == S:
        return Q, S
    return chunk, -(-S // chunk) * chunk


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD scan.  x: (b, S, H, P); dt: (b, S, H) softplus-ed step
    sizes (f32); A: (H,) negative decay rates; B, C: (b, S, N); D: (H,)
    skip.  Returns y (b, S, H, P) in x's dtype.  Computes in f32 (f64
    for f64 inputs)."""
    b, S, H, P = x.shape
    f = torch.promote_types(x.dtype, torch.float32)
    N = B.shape[-1]
    Q, Sp = chunk_plan(S, chunk)
    if Sp != S:         # zero rows at the end: causal, so exact
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, Sp - S))
                       for t in (x, dt, B, C))
    nC = Sp // Q
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    neg_inf = torch.tensor(float("-inf"), device=x.device)
    state = torch.zeros((b, H, N, P), dtype=f, device=x.device)
    ys = []
    for c in range(nC):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq = x[:, sl], dt[:, sl]
        Bq, Cq = B[:, sl].to(f), C[:, sl].to(f)
        xf = xq.to(f)
        dA = dtq * A                                          # (b, Q, H)
        dA_cum = torch.cumsum(dA, dim=1)
        # L[i, j] = exp(cum[i] - cum[j]) for i >= j.  Masked to -inf
        # BEFORE the exp: for i < j the difference is positive and
        # overflows, and a mask after the exp puts NaN into the backward
        seg = dA_cum[:, :, None, :] - dA_cum[:, None, :, :]  # (b, Q, Q, H)
        L = torch.exp(torch.where(causal[None, :, :, None], seg, neg_inf))
        CB = torch.einsum("bqn,bkn->bqk", Cq, Bq)             # (b, Q, Q)
        att = CB[..., None] * L                               # (b, Q, Q, H)
        xdt = xf * dtq[..., None]
        y_diag = torch.einsum("bqkh,bkhp->bqhp", att, xdt)
        # inter-chunk: C_i · exp(cum[i]) · the carried state
        y_off = torch.einsum("bqn,bhnp->bqhp", Cq, state) \
            * torch.exp(dA_cum)[..., None]
        decay_to_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)  # (b, Q, H)
        st = torch.einsum("bqn,bqhp->bhnp", Bq,
                          xf * (decay_to_end * dtq)[..., None])
        state = state * torch.exp(dA_cum[:, -1, :])[..., None, None] + st
        ys.append((y_diag + y_off).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :S].to(f)
    y = y + x[:, :S].to(f) * D[None, None, :, None]
    return y.to(x.dtype)


def ssd_final_state(x, dt, A, B):
    """The SSM state after the last row (the reference's
    ``_ssd_with_state``): sum over s of exp(cum[S-1] - cum[s]) · dt_s ·
    B_s x_s^T, from the unpadded inputs.  (b, H, N, P) in f32 (f64 for
    f64 inputs)."""
    f = torch.promote_types(x.dtype, torch.float32)
    dA_cum = torch.cumsum(dt * A, dim=1)                       # (b, S, H)
    w = torch.exp(dA_cum[:, -1:, :] - dA_cum) * dt
    return torch.einsum("bsn,bshp->bhnp", B.to(f), x.to(f) * w[..., None])


def _in_proj(p, cfg: ModelConfig, x, tp=None):
    """norm -> in_proj: (z, xBC, dt).  Under tensor parallelism
    ``in_proj`` is a column shard of its flat (not head-aligned) output,
    gathered (every shard then holds the whole z, xBC and dt, and reads
    them alike), or, where its columns do not divide over the shards, a
    replicated weight that every shard applies alike to the normed x
    (not through ``copy``: its gradient is whole on every shard)."""
    s, d_inner, H = _dims(cfg)
    h = rmsnorm(p["norm"], x, cfg.rms_norm_eps)
    width = 2 * d_inner + 2 * s.d_state + H
    if tp is None or p["in_proj"]["w"].shape[-1] == width:
        return _split_in_proj(cfg, linear(p["in_proj"], h))
    return _split_in_proj(cfg, tp.gather(linear(p["in_proj"], tp.copy(h))))


def _mixer_inputs(p, cfg: ModelConfig, x, conv_state=None, tp=None):
    """norm -> in_proj -> conv: (z, xs, B, C, dt f32, A, conv state)."""
    s, d_inner, H = _dims(cfg)
    N = s.d_state
    z, xBC, dt = _in_proj(p, cfg, x, tp)
    xBC, conv = _causal_conv(p["conv_w"], p["conv_b"], xBC, conv_state)
    xs, B, C = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, xs, B, C, dt, A, conv


def _mixer_out(p, cfg: ModelConfig, x, y, z, tp=None):
    """Gate, output norm, out_proj, residual.  y: (b, S, d_inner).  Under
    tensor parallelism ``out_proj`` is a row shard of the flattened
    (heads x head_dim) rows (a head cut where the heads do not divide):
    this shard's rows of the normed y (through ``copy``), the products
    summed over ``model``."""
    y = y * F.silu(z)
    y = rmsnorm(p["out_norm"], y, cfg.rms_norm_eps)
    w = p["out_proj"]["w"]
    if w.shape[-2] != y.shape[-1]:
        y = tp.copy(y).narrow(-1, tp.m * w.shape[-2], w.shape[-2])
        return x + tp.reduce(y @ w)
    return x + linear(p["out_proj"], y)


def _heads_split(p, cfg: ModelConfig, tp) -> bool:
    """Whether this block splits its scan's heads over ``model`` (its
    ``out_proj`` is a row shard)."""
    return tp is not None and p["out_proj"]["w"].shape[-2] != _dims(cfg)[1]


def mamba_fwd(p, cfg: ModelConfig, x, with_state: bool = False, tp=None):
    """Training/prefill forward.  x: (B, S, D) -> x + the block.  With
    ``with_state`` also the decode cache after the last row: {"conv": the
    last d_conv - 1 pre-activation conv inputs, zero-padded in front for
    a prompt shorter than that; "ssm": the state}.

    ``tp`` (a ``dist.tp.Shards``): the gathered ``in_proj`` output and
    the conv are whole on every shard; when ``out_proj``'s rows split,
    the chunked scan runs on this shard's whole heads
    (``layers.head_slots``: its H/mp heads, or ceil(H/mp) slots, repeats
    of the last head past it, where the rows cut a head; x, dt,
    A and D through ``copy``, B and C whole: each shard's gradients there
    are its heads' part, summed over ``model``), its y gathered over the
    heads (the repeated slots dropped) for the output norm over the whole
    d_inner, and ``out_proj`` takes this shard's rows.  The state returned
    is whole (its heads gathered)."""
    s, d_inner, H = _dims(cfg)
    b, S, _ = x.shape
    P = s.head_dim
    z, xs, B, C, dt, A, conv = _mixer_inputs(p, cfg, x, tp=tp)
    xh = xs.reshape(b, S, H, P)
    Dk = p["D"]
    split = _heads_split(p, cfg, tp)
    if split:
        idx = head_slots(H, tp)
        xh = _take(tp.copy(xh), idx, 2)
        dt = _take(tp.copy(dt), idx, 2)
        A = _take(tp.copy(A), idx, 0)
        Dk = _take(tp.copy(Dk), idx, 0)
        B, C = tp.copy(B), tp.copy(C)
        y = tp.gather(ssd_chunked(xh, dt, A, B, C, Dk, s.chunk_size),
                      2)[:, :, :H]
    else:
        y = ssd_chunked(xh, dt, A, B, C, Dk, s.chunk_size)
    out = _mixer_out(p, cfg, x, y.reshape(b, S, d_inner), z, tp)
    if not with_state:
        return out
    ssm = ssd_final_state(xh, dt, A, B)
    if split:
        ssm = tp.model.all_gather(ssm, 1)[:, :H]
    return out, {"conv": conv, "ssm": ssm}


def mamba_decode(p, cfg: ModelConfig, x, cache, tp=None, seq=None):
    """One token's recurrent update, O(1) in the sequence length.  x: (B,
    1, D); cache: {"conv": (B, K-1, conv_dim), "ssm": (B, H, N, P) f32},
    written IN PLACE.  Returns (x + the block, cache).

    ``tp``: the cache holds this shard's block of the conv channels and
    of the state's N (the reference's rule puts ``model`` on the last
    dim of conv and on N of ssm): the conv runs on the channel block, its
    output gathered; the recurrence updates this shard's N slice, y's
    partial sums over N all-reduced over ``model``.  ``seq`` (batch 1,
    the cache split over that group by the reference's rule): where it
    divides them, the state holds this member's block of the heads, its
    y gathered over the group, and the conv state this member's block of
    the d_conv - 1 rows, gathered before the conv, each member keeping
    its block of the shifted state."""
    s, d_inner, H = _dims(cfg)
    P, N = s.head_dim, s.d_state
    b = x.shape[0]
    z, xBC, dt = _in_proj(p, cfg, x, tp)
    state, rows = cache["conv"], cache["conv"].shape[1]
    if rows != s.d_conv - 1:
        state = seq.all_gather(state, 1)          # the rows over ``seq``
    cw = state.shape[-1]
    if cw != xBC.shape[-1]:
        lo = tp.m * cw
        out, conv = _causal_conv(p["conv_w"].narrow(-1, lo, cw),
                                 p["conv_b"].narrow(-1, lo, cw),
                                 xBC.narrow(-1, lo, cw), state)
        xBC = tp.model.all_gather(out, -1)
    else:
        xBC, conv = _causal_conv(p["conv_w"], p["conv_b"], xBC, state)
    if rows != s.d_conv - 1:
        conv = conv.narrow(1, seq.index * rows, rows)
    xs, B, C = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    Hl, Nl = cache["ssm"].shape[1:3]
    h0 = seq.index * Hl if Hl != H else 0
    n0 = tp.m * Nl if Nl != N else 0
    dtl = dt[:, 0, h0:h0 + Hl]
    dA = torch.exp(dtl * A[h0:h0 + Hl])                         # (B, H)
    xh = xs.reshape(b, H, P)[:, h0:h0 + Hl].float()
    dBx = torch.einsum("bn,bhp->bhnp", B[:, 0, n0:n0 + Nl].float(),
                       xh * dtl[..., None])
    ssm = cache["ssm"] * dA[..., None, None] + dBx              # (B,H,N,P)
    y = torch.einsum("bn,bhnp->bhp", C[:, 0, n0:n0 + Nl].float(), ssm)
    if Nl != N:
        y = tp.model.all_reduce(y)
    y = y + xh * p["D"][None, h0:h0 + Hl, None]
    if Hl != H:
        y = seq.all_gather(y, 1)
    cache["conv"].copy_(conv)
    cache["ssm"].copy_(ssm)
    return _mixer_out(p, cfg, x, y.reshape(b, 1, d_inner).to(x.dtype),
                      z, tp), cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device, lead=()):
    s, d_inner, H = _dims(cfg)
    conv_dim = d_inner + 2 * s.d_state
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, H, s.d_state, s.head_dim),
                           dtype=torch.float32, device=device),
    }
