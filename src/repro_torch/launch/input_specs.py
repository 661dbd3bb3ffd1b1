"""Meta-device stand-ins for every model input (counterpart of
``repro.launch.input_specs``): the dry run reads their shapes and dtypes,
so nothing is allocated for the production shapes.

``batch_specs(cfg, shape)`` is what the step of that kind takes:
  train   -> {"tokens", "labels"[, "encoder_embeds"]}
  prefill -> {"tokens"[, "encoder_embeds"]}
  decode  -> {"tokens" (B, 1)}, with the cache of ``cache_specs``.
Token ids are int64, as the port's steps take them (``launch.train.
to_device``; the reference declares int32), and encoder embeddings f32,
as the port's data stream gives them and its cross-attention reads them
(the reference declares the model dtype).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import Model, build_model
from repro_torch.utils.tree import tree_map

META = torch.device("meta")
TOKEN_DTYPE = torch.int64
ENCODER_DTYPE = torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {"tokens": _meta((B, S), TOKEN_DTYPE),
               "labels": _meta((B, S), TOKEN_DTYPE)}
    elif shape.kind == "prefill":
        out = {"tokens": _meta((B, S), TOKEN_DTYPE)}
    elif shape.kind == "decode":
        out = {"tokens": _meta((B, 1), TOKEN_DTYPE)}
    else:
        raise ValueError(shape.kind)
    if cfg.num_encoder_tokens and shape.kind in ("train", "prefill"):
        out["encoder_embeds"] = _meta(
            (B, cfg.num_encoder_tokens, cfg.encoder_dim), ENCODER_DTYPE)
    return out


def cache_specs(model: Model, shape: InputShape):
    """The cache of ``shape``'s batch and length (decode's input,
    prefill's output)."""
    return model.init_cache(shape.global_batch, shape.seq_len, META)


def params_specs(model: Model):
    """The params on the meta device: a new tree of the same meta
    leaves each call (a config's leaves are built once)."""
    return tree_map(lambda x: x, _meta_params(model.cfg))


@functools.lru_cache(maxsize=32)
def _meta_params(cfg: ModelConfig):
    return build_model(cfg).init(torch.Generator(), META)
