"""Param-tree helpers: nested dicts/lists of tensors, flattened in the
reference's leaf order.

JAX flattens a dict in sorted-key order and a list in index order; every
leaf is raveled row-major.  ``core.sparsify.build_layout``'s offsets and
the compressor's flat gradient depend on that order, so the port uses it
everywhere (counterpart of ``repro.utils.tree``).
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def keystr_path(path) -> str:
    """'/'-joined key path, as ``repro.utils.tree.keystr_path`` gives it."""
    return "/".join(str(k) for k in path)


def tree_leaves_with_path(tree: Any, prefix: Tuple = ()) -> List[Tuple]:
    """[(path tuple, leaf)] in the reference's (sorted-key) order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves_with_path(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out.extend(tree_leaves_with_path(x, prefix + (i,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_count_params(tree: Any) -> int:
    return int(sum(int(np.prod(l.shape)) for l in tree_leaves(tree)))


def tree_flatten_vector(tree: Any, dtype=torch.float32) -> torch.Tensor:
    """Every leaf raveled and concatenated: the paper's concatenate(g_l)."""
    return torch.cat([l.reshape(-1).to(dtype) for l in tree_leaves(tree)])


def _rebuild(tree: Any, by_path: dict, prefix: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], by_path, prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, by_path, prefix + (i,))
                          for i, x in enumerate(tree))
    return by_path[prefix]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``leaves``, given in
    :func:`tree_leaves` order.  The recursion is a module function: a
    nested one that calls itself is a reference cycle (function -> its
    closure cell -> function), which would keep every leaf alive until
    the garbage collector runs."""
    by_path = dict(zip((p for p, _ in tree_leaves_with_path(like)), leaves))
    return _rebuild(like, by_path)


def tree_unflatten_vector(vector: torch.Tensor, like: Any) -> Any:
    """Inverse of :func:`tree_flatten_vector`, in ``like``'s shapes and
    dtypes."""
    out, offset = [], 0
    for leaf in tree_leaves(like):
        n = int(np.prod(leaf.shape))
        out.append(vector[offset:offset + n].view(leaf.shape).to(leaf.dtype))
        offset += n
    return tree_unflatten(like, out)


def tree_digest(tree: Any) -> Tuple[str, dict]:
    """sha256 over every leaf of ``tree`` in tree order (its path, dtype,
    shape and bytes), and each leaf's own, by path.  Equal digests mean
    bitwise equal trees, wherever each lives."""
    whole, leaves = hashlib.sha256(), {}
    for path, leaf in tree_leaves_with_path(tree):
        t = leaf.detach().contiguous()
        h = hashlib.sha256(f"{keystr_path(path)}:{t.dtype}:"
                           f"{tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(torch.uint8).cpu().numpy())
        leaves[keystr_path(path)] = h.hexdigest()
        whole.update(h.digest())
    return whole.hexdigest(), leaves
