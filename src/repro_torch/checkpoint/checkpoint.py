"""Flat-npz checkpoints (counterpart of ``repro.checkpoint.checkpoint``):
a tree of tensors <-> an .npz with one entry per leaf, keyed by its
``keystr_path``, plus ``__step__``; written to a temporary file and
renamed, so a crash never leaves half a file.  The files are the
reference's: either package reads the other's.

The trainer saves the full train state, ``{"params", "opt_state",
"comp_state"}``: the EF residuals u, v in ``comp_state`` hold every
gradient coordinate not yet sent, and a resume without them would lose
those.

A bf16 leaf is written as the reference writes it, a 2-byte void entry
(``|V2``) holding the bf16 bits, and such an entry is read back as bf16
bits where the template's leaf is bf16 (the reference's own loader
cannot read it).
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import (keystr_path, tree_leaves_with_path,
                                    tree_unflatten)


class CheckpointError(ValueError):
    """A checkpoint that cannot restore into the requested template:
    missing keys or shape mismatches."""


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view("V2")
    return leaf.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == np.dtype("V2") and like.dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {keystr_path(path): _to_numpy(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


def save_checkpoint(path: str, tree: Any, step: int) -> None:
    payload = _flatten(tree)
    payload["__step__"] = np.asarray(step, np.int64)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, template: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``template``, each leaf in the
    template leaf's dtype and on its device; returns (tree, step).
    Raises :class:`CheckpointError` when the file has no ``__step__``,
    misses a template key, or holds another shape."""
    with np.load(path) as z:
        present = set(z.files)
        if "__step__" not in present:
            raise CheckpointError(
                f"{path}: no '__step__' entry — not a checkpoint "
                f"written by save_checkpoint")
        step = int(z["__step__"])
        flat = tree_leaves_with_path(template)
        leaves = []
        for p, leaf in flat:
            key = keystr_path(p)
            if key not in present:
                raise CheckpointError(
                    f"{path}: missing entry {key!r} — this checkpoint "
                    f"predates the full-state (params, opt_state, "
                    f"comp_state) format or belongs to a different "
                    f"model/config (it has {len(present) - 1} entries; "
                    f"the template needs {len(flat)})")
            arr = z[key]
            if arr.shape != tuple(leaf.shape):
                raise CheckpointError(
                    f"{path}: shape mismatch at {key!r}: checkpoint has "
                    f"{tuple(arr.shape)}, template expects "
                    f"{tuple(leaf.shape)}")
            leaves.append(_from_numpy(arr, leaf))
    return tree_unflatten(template, leaves), step
