"""Flash attention with a recompute backward (counterpart of
``repro.models.flash``).

The forward is an online softmax over KV chunks, one query chunk at a
time, and keeps only (o, lse); the backward recomputes each chunk pair's
probabilities from them and accumulates dq, dk, dv, so the live memory
stays O(cq·ck) at any sequence length instead of the (S, S) scores a
full-matrix attention holds (and autograd would keep) a layer.  The
reference's version is plain jnp with a custom VJP, not a Pallas kernel,
so this one is plain PyTorch: a ``torch.autograd.Function`` whose loops
keep the reference's einsum layouts (query head h = kh·G + g), f32
scores, its fully-masked-row guards and its order of sums.

Two things differ from the reference, neither in the values beyond the
order of f32 sums:

- **The chunk rule** (``chunk_plan``).  The reference halves a chunk
  until it divides the length (``_chunks``), so a length with a small
  power-of-two factor collapses to 1-row chunks: 4097 gives 16.8M chunk
  pairs a layer, 32769 about 1.07e9, which an eager loop never finishes.
  The port keeps ``_chunks`` wherever it gives at least ``MIN_CHUNK``
  rows (or the whole length), and otherwise pads the queries and keys up
  to a multiple of the full chunk: padded keys are masked by their index
  (p = 0, corr = 1: they add exactly 0) and padded query rows are
  dropped (their do is 0, so they add exactly 0 to dk and dv).  This is
  a deliberate departure from the reference (ROADMAP.md Queue 3).
- **Masked chunk pairs are skipped** (``_pair``).  A pair that the causal
  mask, the window or the key padding hides entirely leaves m, l and o
  bit for bit as they were (corr = 1 and p = 0; before the first visible
  pair m stays -inf and corr 0), and adds 0 to every gradient, so the
  loops skip it: half the work of a causal prefill.  A pair with nothing
  masked skips the mask.  ``tests/test_torch_flash.py`` holds both equal
  to the loop that masks every pair.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Q_CHUNK, KV_CHUNK = 512, 1024      # the reference's largest chunks
MIN_CHUNK = 64                     # below this the port pads instead

HIDDEN, PARTLY, VISIBLE = 0, 1, 2  # _pair's classes


def _chunks(q_len: int, kv_len: int) -> Tuple[int, int]:
    """The reference's rule: the largest chunk (<= 512 query rows,
    <= 1024 keys) that halving reaches and that divides the length."""
    cq, ck = min(q_len, Q_CHUNK), min(kv_len, KV_CHUNK)
    while q_len % cq:
        cq //= 2
    while kv_len % ck:
        ck //= 2
    return max(cq, 1), max(ck, 1)


def chunk_plan(q_len: int, kv_len: int) -> Tuple[int, int, int, int]:
    """(cq, ck, padded q_len, padded kv_len).  The reference's ``_chunks``
    where its chunk has at least ``MIN_CHUNK`` rows or is the whole
    length; otherwise the full chunk, with the length padded up to a
    multiple of it."""
    cq, ck = _chunks(q_len, kv_len)
    if cq < min(q_len, MIN_CHUNK):
        cq = Q_CHUNK
    if ck < min(kv_len, MIN_CHUNK):
        ck = KV_CHUNK
    return cq, ck, -(-q_len // cq) * cq, -(-kv_len // ck) * ck


def _pair(i: int, j: int, cq: int, ck: int, kv_len: int, causal: bool,
          window: int, positions: bool) -> int:
    """HIDDEN if the mask hides every (query, key) of query chunk i and
    key chunk j, VISIBLE if it hides none, else PARTLY.  Positions are
    the rows' indices; with explicit ``positions`` every pair is PARTLY."""
    if positions:
        return PARTLY
    q0, q1 = i * cq, i * cq + cq - 1
    k0, k1 = j * ck, min(j * ck + ck, kv_len) - 1
    if k0 >= kv_len or (causal and q1 < k0) or (window and q0 - k1 >= window):
        return HIDDEN
    if (j * ck + ck <= kv_len and (not causal or q0 >= k1)
            and (not window or q1 - k0 < window)):
        return VISIBLE
    return PARTLY


def _mask(qp, kp, causal: bool, window: int, k_valid):
    """(cq, ck) bool: key kp visible to query qp."""
    m = torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool,
                   device=qp.device)
    if causal:
        m &= qp[:, None] >= kp[None, :]
    if window:
        m &= qp[:, None] - kp[None, :] < window
    return m & k_valid[None, :]


def _q_chunks(x, cq: int, padded: int, kv_heads: int):
    """(B, S, H, D) -> f32 (nq, B, KH, G·cq, D), rows padded with 0 to
    ``padded``; row g·cq + r of chunk i is position i·cq + r of query head
    kh·G + g."""
    B, S, H, D = x.shape
    G = H // kv_heads
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, padded - S))
    return xf.view(B, padded // cq, cq, kv_heads, G, D).permute(
        1, 0, 3, 4, 2, 5).reshape(padded // cq, B, kv_heads, G * cq, D)


def _kv_chunks(x, ck: int, padded: int):
    """(B, S, KH, D) -> f32 (nk, B, KH, ck, D), rows padded with 0."""
    B, S, KH, D = x.shape
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, padded - S))
    return xf.view(B, padded // ck, ck, KH, D).permute(1, 0, 3, 2, 4) \
        .contiguous()


def _unchunk_q(xc, S: int, G: int, dtype):
    """Inverse of ``_q_chunks``: (nq, B, KH, G·cq, D) -> (B, S, H, D)."""
    nq, B, KH, rows, D = xc.shape
    cq = rows // G
    return xc.view(nq, B, KH, G, cq, D).permute(1, 0, 4, 2, 3, 5).reshape(
        B, nq * cq, KH * G, D)[:, :S].to(dtype)


class _Plan:
    """Chunk sizes, padded lengths and masks of one attention call."""

    def __init__(self, q, k, causal: bool, window: int, q_positions=None,
                 kv_positions=None):
        B, self.Sq, H, self.D = q.shape
        self.Sk, self.KH = k.shape[1], k.shape[2]
        self.B, self.G = B, H // self.KH
        self.causal, self.window = causal, window
        self.cq, self.ck, Sqp, Skp = chunk_plan(self.Sq, self.Sk)
        self.nq, self.nk, self.Sqp, self.Skp = (Sqp // self.cq,
                                                Skp // self.ck, Sqp, Skp)
        self.explicit = q_positions is not None or kv_positions is not None
        dev = q.device
        if q_positions is None:
            q_positions = torch.arange(self.Sq, device=dev)
        if kv_positions is None:
            kv_positions = torch.arange(self.Sk, device=dev)
        # padded rows get position 0: padded keys are hidden by k_valid,
        # padded query rows are dropped
        self.qpos = F.pad(q_positions, (0, Sqp - self.Sq)).view(self.nq,
                                                                self.cq)
        self.kpos = F.pad(kv_positions, (0, Skp - self.Sk)).view(self.nk,
                                                                 self.ck)
        self.k_valid = (torch.arange(Skp, device=dev) < self.Sk).view(
            self.nk, self.ck)

    def pair(self, i: int, j: int) -> int:
        return _pair(i, j, self.cq, self.ck, self.Sk, self.causal,
                     self.window, self.explicit)

    def hidden(self, i: int, j: int):
        """~mask of the pair, shaped to broadcast over (B, KH, G, cq, ck)."""
        return ~_mask(self.qpos[i], self.kpos[j], self.causal, self.window,
                      self.k_valid[j])

    def rows(self, t):
        """(B, KH, G·cq, ck) -> (B, KH, G, cq, ck), for the mask."""
        return t.view(self.B, self.KH, self.G, self.cq, -1)


def _forward(q, k, v, causal: bool, window: int, q_positions=None,
             kv_positions=None):
    """The reference's ``_flash_fwd_impl`` (and ``blockwise_attention``
    with explicit positions).  Returns (o (B, Sq, H, Dv) in q's dtype,
    lse (nq, B, KH, G·cq) f32)."""
    pl = _Plan(q, k, causal, window, q_positions, kv_positions)
    scale = 1.0 / math.sqrt(pl.D)
    Dv = v.shape[-1]
    qc = _q_chunks(q, pl.cq, pl.Sqp, pl.KH)
    kc, vc = _kv_chunks(k, pl.ck, pl.Skp), _kv_chunks(v, pl.ck, pl.Skp)
    rows = pl.G * pl.cq
    out = torch.empty((pl.nq, pl.B, pl.KH, rows, Dv), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((pl.nq, pl.B, pl.KH, rows), dtype=torch.float32,
                      device=q.device)
    for i in range(pl.nq):
        m = torch.full((pl.B, pl.KH, rows), float("-inf"),
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((pl.B, pl.KH, rows, Dv), dtype=torch.float32,
                        device=q.device)
        for j in range(pl.nk):
            kind = pl.pair(i, j)
            if kind == HIDDEN:
                continue
            s = torch.matmul(qc[i], kc[j].transpose(-1, -2)).mul_(scale)
            if kind == PARTLY:
                hide = pl.hidden(i, j)
                pl.rows(s).masked_fill_(hide, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = s.sub_(m_safe[..., None]).exp_()
            if kind == PARTLY:
                pl.rows(p).masked_fill_(hide, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.matmul(p, vc[j])
            m = m_new
        l_safe = torch.clamp_min(l, 1e-20)
        out[i] = o / l_safe[..., None]
        lse[i] = m + torch.log(l_safe)
    return _unchunk_q(out, pl.Sq, pl.G, q.dtype), lse


def _backward(q, k, v, o, lse, do, causal: bool, window: int):
    """The reference's ``_flash_bwd``: Drow = rowsum(do·o) in f32, then
    each pair's probabilities recomputed from lse, and dq, dk, dv in f32,
    each cast to its input's dtype.  The reference runs a KV-outer /
    Q-inner loop for dk, dv and a second, Q-outer loop for dq (so a scan
    carries one chunk's dq); here one KV-outer loop accumulates all
    three: each dq[i] still sums over the key chunks in the reference's
    order, and each pair's probabilities are recomputed once, not twice."""
    pl = _Plan(q, k, causal, window)
    scale = 1.0 / math.sqrt(pl.D)
    qc = _q_chunks(q, pl.cq, pl.Sqp, pl.KH)
    kc, vc = _kv_chunks(k, pl.ck, pl.Skp), _kv_chunks(v, pl.ck, pl.Skp)
    doc = _q_chunks(do, pl.cq, pl.Sqp, pl.KH)
    # a dot over d, as the reference's einsum is (products not rounded)
    Drow = torch.matmul(doc.unsqueeze(-2), _q_chunks(
        o, pl.cq, pl.Sqp, pl.KH).unsqueeze(-1))[..., 0, 0]

    def probs(i, j, kind):
        s = torch.matmul(qc[i], kc[j].transpose(-1, -2)).mul_(scale)
        p = s.sub_(lse[i][..., None]).exp_()
        if kind == PARTLY:
            pl.rows(p).masked_fill_(pl.hidden(i, j), 0.0)
        return p

    def dscores(i, j, p):
        dp = torch.matmul(doc[i], vc[j].transpose(-1, -2))
        return dp.sub_(Drow[i][..., None]).mul_(p).mul_(scale)

    dq, dk, dv = (torch.zeros_like(x) for x in (qc, kc, vc))
    for j in range(pl.nk):
        for i in range(pl.nq):
            kind = pl.pair(i, j)
            if kind == HIDDEN:
                continue
            p = probs(i, j, kind)
            dv[j] += torch.matmul(p.transpose(-1, -2), doc[i])
            ds = dscores(i, j, p)
            dk[j] += torch.matmul(ds.transpose(-1, -2), qc[i])
            dq[i] += torch.matmul(ds, kc[j])

    def unchunk_kv(x, like):
        nk, B, KH, ck, D = x.shape
        return x.permute(1, 0, 3, 2, 4).reshape(B, nk * ck, KH, D)[
            :, :pl.Sk].to(like.dtype)
    return (_unchunk_q(dq, pl.Sq, pl.G, q.dtype), unchunk_kv(dk, k),
            unchunk_kv(dv, v))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k: (B, S, KH, D); v: (B, S, KH, Dv), H % KH == 0
    (query head h reads kv head h // (H / KH)).  Positions are arange(S).
    Scores in f32; returns (B, S, H, Dv) in q's dtype.  Differentiable,
    with the recompute backward."""
    return _FlashAttention.apply(q, k, v, causal, window)


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        q_positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None):
    """Online-softmax attention tiled over query and KV chunks, with
    explicit positions (the reference's ``layers.blockwise_attention``).
    q: (B, Sq, H, D); k: (B, Sk, KH, D); v: (B, Sk, KH, Dv) with H % KH
    == 0; positions default to arange.  window > 0 keeps keys j with
    i - window < j.  Returns (B, Sq, H, Dv) in q's dtype.  The forward
    alone: its chunk arithmetic runs in place, which autograd refuses."""
    return _forward(q, k, v, causal, window, q_positions, kv_positions)[0]
