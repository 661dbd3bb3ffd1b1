"""The decoder of attention blocks (counterpart of ``repro.models.model``
for ``block_pattern == ("attn",)``: the dense family and musicgen's).

Params keep the reference's tree: ``{"embed": {"w"}, "final_norm":
{"scale"}, "blocks": {"p0": {"mixer": ..., "ffn": ...}}, ["lm_head"]}``
with every block leaf stacked along a leading ``n_blocks`` axis, so the
flat gradient has the reference's layout.  ``loss`` remats each block
and each cross-entropy chunk (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does, and its attention keeps no (S, S)
matrix (``flash``), so training lengths reach the reference's
``train_4k``.  Serving: ``init_cache``, ``prefill`` (the prompt's
last-token logits and the filled cache) and ``decode_step`` (one token
from the cache, which it updates in place), with the cache tree ``{"p0":
{"k", "v": (n_blocks, B, S, KH, hd), "pos": (n_blocks, S)}}`` as the
reference stacks it.  MoE, MLA, Mamba, cross-attention and multi-token
prediction, and their caches, are not ported yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_count_params, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig):
    return _DTYPES[cfg.dtype]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.block_pattern != (ATTN,):
            raise NotImplementedError(
                f"{self.cfg.name}: block pattern {self.cfg.block_pattern}; "
                "only attention blocks are ported (ROADMAP.md Queue 1, "
                "'modules to port')")

    def init(self, gen: torch.Generator, device="cpu") -> Dict[str, Any]:
        cfg, dtype = self.cfg, _dtype(self.cfg)
        lead = (cfg.n_blocks,)
        params: Dict[str, Any] = {
            "embed": {"w": L._dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                         dtype, device, scale=0.02)},
            "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
            "blocks": {"p0": {
                "mixer": L.init_attention(gen, cfg, dtype, device, lead),
                "ffn": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype,
                                     device, lead),
            }},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.init_linear(gen, cfg.d_model,
                                              cfg.vocab_size, dtype, device)
        return params

    def _lm_head_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"]["w"].T
        return params["lm_head"]["w"]

    def _block_fn(self, params, i: int, h, positions, kv=None):
        """Block i: attention then SwiGLU; its (k, v) is appended to
        ``kv`` if given."""
        p = _block(params, i)
        h, k_v = L.attention_fwd(p["mixer"], self.cfg, h, positions)
        if kv is not None:
            kv.append(k_v)
        return L.swiglu_fwd(p["ffn"], h, self.cfg.rms_norm_eps)

    def _trunk(self, params, tokens, kv=None, remat: bool = False):
        """Embedding and blocks: the hidden states (B, S, D) before the
        final norm; each block's (k, v) is appended to ``kv`` if given.
        ``remat``: each block under ``checkpoint``, which keeps only its
        input and recomputes the rest in the backward."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h = params["embed"]["w"][tokens]
        for i in range(self.cfg.n_blocks):
            if remat:
                # non-reentrant: the params reach the block through the
                # closure, and node_grads differentiates with respect to
                # them; the blocks draw no random numbers
                h = checkpoint(self._block_fn, params, i, h, positions,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = self._block_fn(params, i, h, positions, kv)
        return h

    def loss(self, params, batch, remat: Optional[bool] = None):
        """batch: {"tokens": (B, S), "labels": (B, S) (-1 = pad)} on the
        params' device.  ``remat`` None or True recomputes each block and
        each cross-entropy chunk in the backward (the reference's
        default): the same operations on the same inputs, so the same
        values (bit for bit where the embedding's backward sums in a fixed
        order).  Returns (loss, metrics)."""
        cfg = self.cfg
        remat = True if remat is None else remat
        h = L.rmsnorm(params["final_norm"],
                      self._trunk(params, batch["tokens"], remat=remat),
                      cfg.rms_norm_eps)
        xent, n_tok = _chunked_xent(h, self._lm_head_w(params),
                                    batch["labels"], remat=remat)
        loss = xent / torch.clamp(n_tok, min=1.0)
        metrics = {"xent": loss, "aux_loss": torch.zeros_like(loss),
                   "tokens": n_tok, "loss": loss}
        return loss, metrics

    def param_count(self) -> int:
        return tree_count_params(self.init(torch.Generator(), "meta"))

    # -- inference ------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int, device="cpu"):
        """An empty cache for ``seq_len`` positions (the window under a
        sliding window), stacked over the blocks."""
        return {"p0": L.init_attention_cache(self.cfg, batch, seq_len,
                                             _dtype(self.cfg), device,
                                             lead=(self.cfg.n_blocks,))}

    @torch.no_grad()
    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """Process a whole prompt (no gradient, no remat).  batch:
        {"tokens": (B, S)} on the params' device; cache_len: the cache's
        capacity (>= S, default S).  Returns (last-token logits (B, 1, V)
        f32, the filled cache: under a sliding window, a prompt longer
        than the window keeps its last ``window`` positions in ring order,
        slot = pos % window)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        kv = []
        h = self._trunk(params, tokens, kv)
        cache = self.init_cache(B, cache_len or S, tokens.device)
        c = cache["p0"]
        keep = torch.arange(max(0, S - c["pos"].shape[1]), S,
                            device=tokens.device)
        slots = keep % c["pos"].shape[1]
        for i, (k, v) in enumerate(kv):
            c["k"][i][:, slots] = k[:, keep]
            c["v"][i][:, slots] = v[:, keep]
        c["pos"][:, slots] = keep.to(torch.int32)
        h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.rms_norm_eps)
        return (h @ self._lm_head_w(params)).float(), cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos: int):
        """One decode step.  tokens: (B, 1); pos: the current absolute
        position.  Writes the token's k, v into the cache in place and
        returns (logits (B, 1, V) f32, the cache)."""
        cfg = self.cfg
        h = params["embed"]["w"][tokens]
        for i in range(cfg.n_blocks):
            p = _block(params, i)
            c = {key: x[i] for key, x in cache["p0"].items()}   # views
            h, _ = L.attention_decode(p["mixer"], cfg, h, c, pos)
            h = L.swiglu_fwd(p["ffn"], h, cfg.rms_norm_eps)
        h = L.rmsnorm(params["final_norm"], h, cfg.rms_norm_eps)
        return (h @ self._lm_head_w(params)).float(), cache


def _block(params, i: int):
    """Block i's params: a view of each stacked leaf."""
    return tree_map(lambda t: t[i], params["blocks"]["p0"])


def _xent_chunk(hc, w, lb):
    """One chunk's (sum of xent, valid tokens)."""
    V = w.shape[-1]
    logits = (hc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lb.clamp(0, V - 1).long()[..., None])[..., 0]
    valid = (lb >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def _chunked_xent(h, w, labels, target_chunk_bytes: int = 2 ** 28,
                  remat: bool = False):
    """Cross-entropy in sequence chunks, summed in the reference's order,
    so the (B, chunk, V) logits, not (B, S, V), bound the memory; with
    ``remat`` each chunk is recomputed in the backward, as the
    reference's ``jax.checkpoint`` body is, so no chunk's softmax is kept.
    h: (B, S, D); w: (D, V); labels: (B, S), -1 = ignore.
    Returns (sum_xent, n_tokens), f32 scalars."""
    B, S, _ = h.shape
    V = w.shape[-1]
    chunk = max(8, min(512, target_chunk_bytes // max(1, 4 * B * V)))
    while S % chunk:
        chunk //= 2
    chunk = max(chunk, 1)
    xent = torch.zeros((), dtype=torch.float32, device=h.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        args = (h[:, c:c + chunk], w, labels[:, c:c + chunk])
        if remat:
            x, n = checkpoint(_xent_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, n = _xent_chunk(*args)
        xent = xent + x
        n_tok = n_tok + n
    return xent, n_tok


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
