"""Weights carried across from the JAX package.

The reference's params arrive as nested dicts (and lists) of numpy arrays,
e.g. ``jax.tree_util.tree_map(np.asarray, Model(cfg).init(key))``.  The
port keeps the reference's layouts (stacked blocks, (in, out) linears, WIO
convs of the AE, ConvNet5's HWIO convs and its BN leaves, permuted only
inside ``models.convnet.convnet5_forward``), so conversion is an identity
on shapes and values: ``params_from_numpy`` carries the reference's
``init_convnet5`` weights across as they are.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.dist.sharding import shard_tree
from repro_torch.utils.tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Any, device="cpu", specs=None, coords=None,
                      sizes=None) -> Any:
    """Model params (``repro.models.Model.init`` layout) as tensors; with
    ``specs`` ({path: spec}), the block of each that the device at
    ``coords`` of a mesh of ``sizes`` holds (``dist.sharding.shard_tree``),
    each its own copy."""
    out = tree_map(lambda a: _tensor(a, device), tree)
    if specs is None:
        return out
    return tree_map(lambda t: t.clone(),
                    shard_tree(out, specs, coords or {}, sizes or {}))


def ae_from_numpy(tree: Any, device="cpu") -> Any:
    """Autoencoder params (``repro.core.autoencoder.init_lgc_autoencoder``
    layout: {"encoder": [{"b", "w"}], "decoder": [...]}) as tensors."""
    return tree_map(lambda a: _tensor(a, device), tree)
