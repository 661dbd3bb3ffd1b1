"""The dense decoder (counterpart of ``repro.models.model``, dense family).

Params keep the reference's tree: ``{"embed": {"w"}, "final_norm":
{"scale"}, "blocks": {"p0": {"mixer": ..., "ffn": ...}}, ["lm_head"]}``
with every block leaf stacked along a leading ``n_blocks`` axis, so the
flat gradient has the reference's layout.  Serving: ``init_cache``,
``prefill`` (the prompt's last-token logits and the filled cache) and
``decode_step`` (one token from the cache, which it updates in place),
with the cache tree ``{"p0": {"k", "v": (n_blocks, B, S, KH, hd), "pos":
(n_blocks, S)}}`` as the reference stacks it.  MoE, MLA, Mamba,
cross-attention and multi-token prediction, and their caches, are not
ported yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

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
        if self.cfg.family != "dense" or self.cfg.block_pattern != (ATTN,):
            raise NotImplementedError(
                f"{self.cfg.name}: only the dense decoder is ported "
                "(ROADMAP.md Queue 1, 'other arch families')")

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

    def _trunk(self, params, tokens, kv=None):
        """Embedding and blocks: the hidden states (B, S, D) before the
        final norm; each block's (k, v) is appended to ``kv`` if given."""
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h = params["embed"]["w"][tokens]
        for i in range(cfg.n_blocks):
            p = _block(params, i)
            h, k_v = L.attention_fwd(p["mixer"], cfg, h, positions)
            if kv is not None:
                kv.append(k_v)
            h = L.swiglu_fwd(p["ffn"], h, cfg.rms_norm_eps)
        return h

    def loss(self, params, batch):
        """batch: {"tokens": (B, S), "labels": (B, S) (-1 = pad)} on the
        params' device.  Returns (loss, metrics)."""
        cfg = self.cfg
        h = L.rmsnorm(params["final_norm"],
                      self._trunk(params, batch["tokens"]), cfg.rms_norm_eps)
        xent, n_tok = _chunked_xent(h, self._lm_head_w(params),
                                    batch["labels"])
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

    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """Process a whole prompt.  batch: {"tokens": (B, S)} on the
        params' device; cache_len: the cache's capacity (>= S, default
        S).  Returns (last-token logits (B, 1, V) f32, the filled cache:
        under a sliding window, a prompt longer than the window keeps its
        last ``window`` positions in ring order, slot = pos % window)."""
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


def _chunked_xent(h, w, labels, target_chunk_bytes: int = 2 ** 28):
    """Cross-entropy in sequence chunks, summed in the reference's order.
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
        logits = (h[:, c:c + chunk] @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        lb = labels[:, c:c + chunk]
        gold = logits.gather(-1, lb.clamp(0, V - 1).long()[..., None])[..., 0]
        valid = (lb >= 0).float()
        xent = xent + ((lse - gold) * valid).sum()
        n_tok = n_tok + valid.sum()
    return xent, n_tok


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
