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

One node per process, each process holds only its own node's u, v, (n,)
rows of the emulated (K, n) stacks.  :func:`save_rank_checkpoint` has
each write its own file, ``ckpt.npz`` -> ``ckpt.rank<r>.npz``
(:func:`rank_path`), with its rows under the emulated keys, ``__step__``,
``__mesh__`` and ``__node__``; node 0's file also holds the replicated
rest (params, optimizer state, AE, AE momentum), so the K files stitched
(the rows stacked, the rest node 0's) are the emulated run's file key by
key.  :func:`load_rank_checkpoint` resumes from them, each process
reading only its own file (each host may have its own disk) and node
0's rest reaching the others by broadcast.  A crash between two
processes' renames leaves files of two steps; the processes compare
what their files hold (:func:`check_rank_headers`) before any trains,
and every one raises the same :class:`CheckpointError` on a torn save, a
missing or unreadable file or one of another mesh.
"""
from __future__ import annotations

import os
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path, tree_unflatten)

# the leaves of ``comp_state`` each node holds for itself (its EF
# residuals); the rest of the train state is replicated
NODE_LEAVES = ("u", "v")
# what reading a file that is not a whole checkpoint raises
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


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
    _write(path, payload)


def _write(path: str, payload: Dict[str, np.ndarray]) -> None:
    """``payload`` as an .npz at ``path``: a temporary file, renamed."""
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


# -- one node per process -----------------------------------------------------


def rank_path(path: str, node: int) -> str:
    """Node ``node``'s file of the checkpoint ``path`` saved one node per
    process: ``<dir>/ckpt.npz`` -> ``<dir>/ckpt.rank<node>.npz``."""
    root, ext = os.path.splitext(path)
    return f"{root}.rank{node}{ext or '.npz'}"


def split_node_part(tree: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the node's own part of a train state, ``comp_state``'s
    :data:`NODE_LEAVES`; the replicated rest), as two trees of the
    state's keys."""
    cs = tree.get("comp_state")
    if cs is None:
        return {}, dict(tree)
    node = {"comp_state": {k: cs[k] for k in NODE_LEAVES if k in cs}}
    rest = {**tree, "comp_state": {k: v for k, v in cs.items()
                                   if k not in NODE_LEAVES}}
    return node, rest


def _join(node: Dict[str, Any], rest: Dict[str, Any]) -> Dict[str, Any]:
    if not node:
        return rest
    return {**rest, "comp_state": {**rest["comp_state"],
                                   **node["comp_state"]}}


def save_rank_checkpoint(path: str, tree: Any, step: int,
                         Ks: Sequence[int], node: int) -> None:
    """Node ``node``'s file of the process mesh ``Ks`` at
    ``rank_path(path, node)``, written as :func:`save_checkpoint` writes:
    its own part of the train state ``tree`` (node 0: the whole of it),
    ``__step__``, ``__mesh__`` and ``__node__``.  No collective: each
    process saves on its own."""
    part = tree if node == 0 else split_node_part(tree)[0]
    payload = _flatten(part)
    payload.update(__step__=np.asarray(step, np.int64),
                   __mesh__=np.asarray(tuple(Ks), np.int64),
                   __node__=np.asarray(node, np.int64))
    _write(rank_path(path, node), payload)


def read_rank_header(path: str, node: int) -> Dict[str, Any]:
    """What node ``node``'s file of ``path`` says of itself: {"file",
    "step", "mesh", "node"}, or {"file", "error"} when it is missing or
    is not a rank file."""
    f = rank_path(path, node)
    try:
        with np.load(f) as z:
            return {"file": f, "step": int(z["__step__"]),
                    "mesh": [int(k) for k in z["__mesh__"]],
                    "node": int(z["__node__"])}
    except FileNotFoundError:
        return {"file": f, "error": "missing"}
    except _UNREADABLE as e:
        return {"file": f, "error": f"not a rank file ({type(e).__name__}: "
                                    f"{e})"}


def check_rank_headers(headers: List[Dict[str, Any]],
                       Ks: Sequence[int]) -> int:
    """The step the K nodes' files (``headers[r]``, node r's, as
    :func:`read_rank_header` gives them) resume at.  Raises
    :class:`CheckpointError` naming the files unless every file is there,
    readable, saved on the mesh ``Ks`` by its own node, and all at one
    step (files at two steps are a torn save: a crash between two
    processes' renames)."""
    Ks = [int(k) for k in Ks]
    problems = []
    for r, h in enumerate(headers):
        if "error" in h:
            problems.append(f"{h['file']}: {h['error']}")
        elif h["mesh"] != Ks:
            problems.append(f"{h['file']}: saved on the mesh "
                            f"{tuple(h['mesh'])}, not {tuple(Ks)}")
        elif h["node"] != r:
            problems.append(f"{h['file']}: node {h['node']}'s, not node "
                            f"{r}'s")
    steps = sorted({h["step"] for h in headers if "step" in h})
    if len(steps) > 1:
        problems.append("a torn save, files of steps " + ", ".join(
            f"{h['file']} at {h['step']}" for h in headers if "step" in h))
    if problems:
        raise CheckpointError("cannot resume one node per process: "
                              + "; ".join(problems))
    return steps[0]


def load_rank_checkpoint(path: str, template: Any, mesh) -> Tuple[Any, int]:
    """Resume one node per process from ``path``'s rank files: a
    collective, every process of ``mesh`` (a ``dist.p2p.ProcessMesh``)
    calls it.  Node r reads its own file into ``template``'s structure
    (node 0 the whole state, the others their part), the processes
    exchange what their files hold, and node 0's replicated rest is
    broadcast, bit for bit, into the others' template leaves.  Returns
    (tree, step); every process raises the same :class:`CheckpointError`
    when any file is missing, unreadable, of another mesh or step, so
    none waits for another and none trains."""
    node_t, rest_t = split_node_part(template)
    header = read_rank_header(path, mesh.node)
    own: Optional[Any] = None
    if "error" not in header:
        try:
            own, _ = load_checkpoint(header["file"], template
                                     if mesh.node == 0 else node_t)
        except _UNREADABLE as e:        # CheckpointError included
            header = {"file": header["file"], "error": str(e)}
    step = check_rank_headers(mesh.gather_objects(header), mesh.Ks)
    node, rest = split_node_part(own) if mesh.node == 0 else (own, rest_t)
    rest = tree_unflatten(rest_t, [_broadcast_bits(mesh, x)
                                   for x in tree_leaves(rest)])
    return _join(node, rest), step


def _broadcast_bits(mesh, x: torch.Tensor) -> torch.Tensor:
    """Node 0's ``x`` on every process, moved as its bytes (any dtype)."""
    if x.numel() == 0:
        return x
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    return mesh.broadcast(flat, 0).view(x.dtype).view(x.shape)
