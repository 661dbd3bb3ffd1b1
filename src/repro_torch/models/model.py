"""The dense decoder (counterpart of ``repro.models.model``, dense family).

Params keep the reference's tree: ``{"embed": {"w"}, "final_norm":
{"scale"}, "blocks": {"p0": {"mixer": ..., "ffn": ...}}, ["lm_head"]}``
with every block leaf stacked along a leading ``n_blocks`` axis, so the
flat gradient has the reference's layout.  MoE, MLA, Mamba,
cross-attention, multi-token prediction and prefill/decode are not ported
yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

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

    def loss(self, params, batch):
        """batch: {"tokens": (B, S), "labels": (B, S) (-1 = pad)} on the
        params' device.  Returns (loss, metrics)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h = params["embed"]["w"][tokens]
        for i in range(cfg.n_blocks):
            p = tree_map(lambda t: t[i], params["blocks"]["p0"])
            h = L.attention_fwd(p["mixer"], cfg, h, positions)
            h = L.swiglu_fwd(p["ffn"], h, cfg.rms_norm_eps)
        h = L.rmsnorm(params["final_norm"], h, cfg.rms_norm_eps)
        xent, n_tok = _chunked_xent(h, self._lm_head_w(params), labels)
        loss = xent / torch.clamp(n_tok, min=1.0)
        metrics = {"xent": loss, "aux_loss": torch.zeros_like(loss),
                   "tokens": n_tok, "loss": loss}
        return loss, metrics

    def param_count(self) -> int:
        return tree_count_params(self.init(torch.Generator(), "meta"))


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
