"""The weights, drawn from the seed on the device: each leaf of a
family's ``params_spec`` from a generator of its own (seeded from the
run's seed and the leaf's place), in large calls, straight into its
stored dtype.  Any one leaf can be drawn again alone, which the
comparison uses for the change of the weights.  The autoencoder's
initial weights come the same way."""
from __future__ import annotations

import math
from typing import Dict

import torch

from lgcref import ae as AE

_CHUNK = 1 << 26            # elements drawn per call: bounds the f32 temporary
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_seed(seed: int, i: int) -> int:
    """The generator seed of leaf i (any whole ``seed``)."""
    return (seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (i + 1)) \
        % (1 << 63)


def draw_leaf(spec_entry, seed: int, i: int, device) -> torch.Tensor:
    _path, shape, dtype, init = spec_entry
    dt = _DTYPES[dtype]
    kind = init[0]
    if kind == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, i))
    if kind == "normal":
        out = torch.empty(shape, dtype=dt, device=device)
        flat = out.view(-1)
        for a in range(0, flat.numel(), _CHUNK):
            b = min(a + _CHUNK, flat.numel())
            flat[a:b] = torch.randn(b - a, generator=gen, device=device) \
                .mul_(init[1])
        return out
    u = torch.rand(shape, generator=gen, device=device)
    lo, hi = init[1], init[2]
    if kind == "log_of_uniform":        # log(A), A ~ U[lo, hi]
        return torch.log(lo + (hi - lo) * u).to(dt)
    if kind == "inv_softplus_log_uniform":   # softplus^-1(dt), dt ~ logU
        d = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
        return (d + torch.log(-torch.expm1(-d))).to(dt)
    raise ValueError(f"unknown init {init!r}")


def draw(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every leaf of ``spec``."""
    return {e[0]: draw_leaf(e, seed, i, device) for i, e in enumerate(spec)}


def draw_ae(seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, -2))
    return AE.init(gen, device)


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}; a numeric key makes a list
    (the autoencoder's layers)."""
    tree: Dict = {}
    for path, x in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`nest`."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out
