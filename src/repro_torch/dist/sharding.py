"""Partitioning rules: parameter names -> partition specs (counterpart of
``repro.dist.sharding``).

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
their product).  These are the entries of the reference's
``PartitionSpec``, so ``tuple(reference_spec) == spec``; an entry of one
axis is the bare name, never a 1-tuple.  Trees of specs are flat dicts
``{path: spec}`` in the tree's leaf order (a tuple leaf would read as a
subtree to ``utils.tree``).  Everything is name + shape driven and
replicates a dim that its axes do not divide, so the same rules serve
one device and the production meshes.

Naming convention (paths are '/'-joined key paths, see models/layers.py):
  embed/w                (V, D)        vocab dim over ``model``
  lm_head/w              (D, V)        vocab (out) dim over ``model``
  .../{wq,wk,wv,wq_a,wq_b,wkv_a,wkv_b,w_gate,w_up,in_proj,proj,router,
       shared}/w         (..., D_in, D_out)   column-parallel (out dim)
  .../{wo,w_down,out_proj}/w
                         (..., D_in, D_out)   row-parallel (in dim)
  .../ffn/{w_gate,w_up,w_down}   raw (..., E, _, _) expert stacks: the
                         expert dim over ``model``
  biases, norm scales, SSM vectors: no ``model`` dim.

The FSDP axes then take the largest remaining dim they divide (size > 1;
the lowest such dim on a tie); that includes a leading ``n_blocks`` dim
of stacked blocks and biases, but not norm scales.

``shard_tree`` cuts the block of every leaf that one device (one process
of a ``launch.mesh.ProcessGrid``) holds under a tree of specs, and
``gather_tree`` is its inverse across the processes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.utils.tree import (keystr_path, tree_leaves_with_path,
                                    tree_unflatten)

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# logical layer names whose weight shards its OUTPUT (last) dim
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b",
    "w_gate", "w_up", "in_proj", "proj", "router", "shared",
})
# logical layer names whose weight shards its INPUT (second-to-last) dim
_ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj"})
# MoE expert-stack leaves (raw arrays, no trailing /w)
_EXPERT_STACK = frozenset({"w_gate", "w_up", "w_down"})


def _divisible(dim: int, size: int) -> bool:
    return size <= 1 or (dim > 0 and dim % size == 0)


def _entry(axes: Sequence[str]) -> Entry:
    axes = tuple(axes)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def partition_spec(path: str, shape: Sequence[int], *, model_size: int = 1,
                   fsdp_axes: Sequence[str] = (), fsdp_size: int = 1) -> Spec:
    """The spec of one parameter leaf: ``model`` on the role's dim when
    it divides, then the FSDP axes on the largest remaining dim they
    divide; anything else replicated."""
    segs = path.lower().split("/")
    name = segs[-1]
    logical = segs[-2] if name in ("w", "b") and len(segs) > 1 else name
    nd = len(shape)
    spec: list = [None] * nd

    model_dim: Optional[int] = None
    if nd >= 1 and model_size > 1 and name not in ("b", "scale"):
        if "embed" in segs:
            model_dim = nd - 2 if nd >= 2 else None        # vocab dim
        elif "lm_head" in segs:
            model_dim = nd - 1                              # vocab (out)
        elif name in _EXPERT_STACK and nd >= 3:
            model_dim = nd - 3                              # expert dim
        elif logical in _COL_PARALLEL and nd >= 2:
            model_dim = nd - 1
        elif logical in _ROW_PARALLEL and nd >= 2:
            model_dim = nd - 2
        if model_dim is not None and not _divisible(shape[model_dim],
                                                    model_size):
            model_dim = None
        if model_dim is not None:
            spec[model_dim] = "model"

    if fsdp_axes and fsdp_size > 1 and nd >= 1 and name != "scale":
        cand = [d for d in range(nd)
                if spec[d] is None and _divisible(shape[d], fsdp_size)
                and shape[d] > 1]
        if cand:
            # max() keeps the first of equal sizes: the lowest dim
            best = max(cand, key=lambda d: shape[d])
            spec[best] = _entry(fsdp_axes)
    return tuple(spec)


def param_pspecs(params_tree: Any, *, model_size: int = 1,
                 fsdp_axes: Sequence[str] = (), fsdp_size: int = 1
                 ) -> Dict[str, Spec]:
    """{path: spec} for every leaf of ``params_tree`` (params, gradients
    or an optimizer state: the rules read the trailing path segments, so
    ``m/...`` and ``v/...`` take their parameter's spec)."""
    return {keystr_path(path): partition_spec(
        keystr_path(path), tuple(leaf.shape), model_size=model_size,
        fsdp_axes=fsdp_axes, fsdp_size=fsdp_size)
        for path, leaf in tree_leaves_with_path(params_tree)}


def batch_pspec(dp_axes: Sequence[str]) -> Spec:
    """The batch dim's spec over the data-parallel axes."""
    return (_entry(dp_axes),)


def cache_pspecs(cache_tree: Any, *, dp_axes: Sequence[str], dp_size: int,
                 model_size: int = 1,
                 seq_shard_axis: Optional[str] = None) -> Dict[str, Spec]:
    """{path: spec} of a cache: dim 1 over the dp axes when they divide it
    and it is > 1 (the batch of k, v and states, and the length S of the
    (n_blocks, S) position rings alike), else dim 2 over
    ``seq_shard_axis`` when ``dp_size`` divides it (a long sequence at
    batch 1); dim 3 (the KV heads) over ``model`` when it divides."""
    dp_entry = _entry(dp_axes)
    out: Dict[str, Spec] = {}
    for path, leaf in tree_leaves_with_path(cache_tree):
        shape = tuple(leaf.shape)
        nd = len(shape)
        s: list = [None] * nd
        if nd >= 2:
            if dp_entry is not None and _divisible(shape[1], dp_size) \
                    and shape[1] > 1:
                s[1] = dp_entry
            elif seq_shard_axis and nd >= 3 and shape[2] > 1 \
                    and _divisible(shape[2], dp_size):
                s[2] = seq_shard_axis
        if nd >= 4 and model_size > 1 and _divisible(shape[3], model_size):
            s[3] = "model"
        out[keystr_path(path)] = tuple(s)
    return out


def local_shape(shape: Sequence[int], spec: Spec,
                axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """One device's shard of ``shape`` under ``spec`` on a mesh of
    ``axis_sizes`` (an axis missing from it counts as size 1); raises
    when a dim's axes do not divide it."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None or d >= len(out):
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        denom = int(np.prod([axis_sizes.get(n, 1) for n in names]))
        if denom > 1:
            if out[d] % denom:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {names} ({denom}) under "
                                 f"{spec}")
            out[d] //= denom
    return tuple(out)


def _axes(entry: Entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def dims_over(spec: Spec, axis: str) -> Tuple[int, ...]:
    """The dims of ``spec`` split over ``axis`` (alone or with others)."""
    return tuple(d for d, e in enumerate(spec) if axis in _axes(e))


def spec_axes(spec: Spec) -> frozenset:
    """Every axis ``spec`` splits a dim over."""
    return frozenset(a for e in spec for a in _axes(e))


def block_index(spec: Spec, coords: Dict[str, int],
                sizes: Dict[str, int]) -> Tuple[Tuple[int, int], ...]:
    """Per dim of ``spec``, (i, n): the device at ``coords`` holds block i
    of the dim cut into n, i = i_a0·size_a1·... + i_a1 + ... over the
    dim's axes (a0, a1, ...), the first axis major, as a
    ``PartitionSpec`` lays them; (0, 1) where the entry is None."""
    out = []
    for entry in spec:
        idx, n = 0, 1
        for a in _axes(entry):
            idx, n = idx * sizes.get(a, 1) + coords.get(a, 0), \
                n * sizes.get(a, 1)
        out.append((idx, n))
    return tuple(out)


def shard_tree(full: Any, specs: Dict[str, Spec], coords: Dict[str, int],
               sizes: Dict[str, int]) -> Any:
    """The block of every leaf of ``full`` that the device at ``coords``
    ({axis: index}) holds on a mesh of ``sizes`` under ``specs``
    (:func:`block_index`); a dim whose entry is None stays whole."""
    return tree_unflatten(full, [
        block_of(leaf, specs[keystr_path(path)], coords, sizes)
        for path, leaf in tree_leaves_with_path(full)])


def block_of(x, spec: Spec, coords: Dict[str, int], sizes: Dict[str, int]):
    """The block of one leaf ``x`` that the device at ``coords`` holds
    under ``spec`` (a view; see :func:`shard_tree`)."""
    for d, (idx, n) in enumerate(block_index(spec, coords, sizes)):
        if n > 1:
            w = x.shape[d] // n
            x = x.narrow(d, idx * w, w)
    return x


def gather_tree(local: Any, specs: Dict[str, Spec], groups: Dict[str, Any]
                ) -> Any:
    """The inverse of :func:`shard_tree` across processes: every leaf whole
    on every process, each sharded dim all-gathered over its axes' groups
    ({axis: ``dist.tp.Group``}), the last axis of an entry first."""
    out = []
    for path, x in tree_leaves_with_path(local):
        for d, entry in enumerate(specs[keystr_path(path)]):
            for a in reversed(_axes(entry)):
                x = groups[a].all_gather(x, d)
        out.append(x)
    return tree_unflatten(local, out)
