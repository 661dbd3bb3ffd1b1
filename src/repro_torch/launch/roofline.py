"""Useful work of a step (counterpart of the hardware-free part of
``repro.launch.roofline``): the fraction of parameters a token uses and
the analytic model FLOPs of a dry-run record, by the reference's
formulas.

    train:   6 * N_active * tokens                 (fwd 2x + bwd 4x)
    prefill: 2 * N_active * tokens + causal attention's score and value
             matmuls, 2 * attn_layers * H * hd * S^2 * B
    decode:  2 * N_active * B + the cache read's,
             4 * attn_layers * KH * hd * min(S, window) * B

The reference's TPU v5e hardware model (``PEAK_FLOPS``, ``HBM_BW``,
``ICI_BW``, ``Roofline``, ``analyze_record``) has no counterpart: it
prices XLA's per-device HLO counts, which this port's dry run does not
compile, against a chip the port does not run on.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.input_specs import params_specs
from repro_torch.models.model import build_model
from repro_torch.utils.tree import keystr_path, tree_leaves_with_path


def active_param_fraction(cfg: ModelConfig) -> float:
    """Fraction of the parameters active per token: an MoE expert stack
    counts top_k / num_experts of itself (read from the meta-device
    params)."""
    if cfg.moe is None:
        return 1.0
    total = active = 0.0
    for path, leaf in tree_leaves_with_path(params_specs(build_model(cfg))):
        p = keystr_path(path)
        n = int(np.prod(leaf.shape))
        total += n
        last = p.split("/")[-1]
        if last in ("w_gate", "w_up", "w_down") and leaf.dim() >= 3 \
                and "ffn" in p:
            active += n * cfg.moe.top_k / cfg.moe.num_experts
        else:
            active += n
    return active / max(total, 1)


def model_flops(rec: Dict, cfg: ModelConfig) -> float:
    """Analytic useful FLOPs of the whole step (all devices) of a dry-run
    record (``n_params``, ``global_batch``, ``seq_len``, ``kind``,
    ``sliding_window_substitution``)."""
    n = rec["n_params"]
    n_active = n * active_param_fraction(cfg)
    B, S = rec["global_batch"], rec["seq_len"]
    kind = rec["kind"]
    if kind == "train":
        return 6.0 * n_active * B * S
    # the share of layers that attend (1.0 dense; 1/8 jamba; ...)
    attn_layers = cfg.n_layers * (
        sum(1 for k in cfg.block_pattern if k in ("attn", "cross"))
        / len(cfg.block_pattern)) if cfg.n_heads else 0.0
    if kind == "prefill":
        attn = 2.0 * attn_layers * cfg.n_heads * cfg.head_dim * S * S * B
        return 2.0 * n_active * B * S + attn
    attn = 0.0
    if cfg.n_heads:
        eff = min(S, cfg.sliding_window or S)
        if rec.get("sliding_window_substitution"):
            eff = min(S, 8192)
        attn = 2.0 * 2.0 * attn_layers * cfg.n_kv_heads * cfg.head_dim \
            * eff * B
    return 2.0 * n_active * B + attn
