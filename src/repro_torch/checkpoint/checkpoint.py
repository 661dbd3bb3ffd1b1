"""Flat-npz checkpoints (counterpart of ``repro.checkpoint.checkpoint``):
a tree of tensors <-> an .npz with one entry per leaf, keyed by its
``keystr_path``, plus ``__step__``; written one leaf at a time to a
temporary file and renamed, so a crash never leaves half a file.

The trainer saves the full train state, ``{"params", "opt_state",
"comp_state"}``: the EF residuals u, v in ``comp_state`` hold every
gradient coordinate not yet sent, and a resume without them would lose
those.  A bf16 leaf is written as the reference writes it, a 2-byte void
entry (``|V2``) holding the bf16 bits, and such an entry is read back as
bf16 bits where the template's leaf is bf16 (the reference's own loader
cannot read it).

**The gathered layout** is the reference trainer's ``ckpt.npz``: every
leaf whole, u and v as its (dp, mp, n_local) arrays.  The emulated
trainer writes it (its (K, n) stacks as (K, 1, n), reshaped at the file
boundary), and either package reads the other's.

**One file a rank** is what a run under torchrun writes, on any (pod,
data, model) grid (one node a process is the grid with model 1):
``ckpt.npz`` -> ``ckpt.rank<r>.npz`` (:func:`rank_path`).
- Every key and dtype is the gathered file's; a rank's entry is its
  block of the gathered leaf under the leaf's spec
  (``dist.sharding.block_of``): params and optimizer state under their
  params' specs, u and v under (dp, "model", None), a (1, 1, n_local)
  block at [d, m], the AE and its momentum replicated.
- A rank writes a leaf only if its coordinate is 0 on every dp axis
  (pod, data) the leaf's spec does not split (:func:`writes`): the
  data-0 rank of each model column writes its column's params,
  optimizer and AE blocks, under FSDP every rank its ``data`` blocks,
  every rank its own u, v.
- Nothing is deduplicated over ``model``, because the model shards'
  copies of a leaf the spec leaves whole (a norm scale) differ: each
  (node x model shard) selects the top-k of its own flat gradient, so
  each sends and clears other coordinates of its copy.  The reference's
  save takes device 0's copy of such a leaf (``np.asarray``), and its
  resume hands model shard 1 shard 0's, which is why its resumed
  model-sharded run leaves its uninterrupted trajectory.  The port's
  rank files keep every copy, so a resume from them is the
  uninterrupted run bit for bit.
- The header: ``__step__``, ``__mesh__`` (the dp mesh, (data,) or (pod,
  data)), ``__node__`` (the rank's dp node), ``__model__`` (the model
  shards, the rank's shard) and ``__specs__`` (every key's spec, JSON),
  so a reader needs no model to place the blocks.

:func:`load_rank_checkpoint` resumes from them: each rank reads only its
own file (each host may have its own disk); a leaf its file lacks comes,
as bits, from its dp column's member at 0 on the leaf's unsplit dp axes,
a broadcast over those axes.  A crash between two ranks' renames leaves
files of two steps: the ranks compare what their files hold
(:func:`check_rank_headers`) before any trains, and every one raises the
same :class:`CheckpointError` on a torn save, a missing or unreadable
file, or one of another grid or rank.

Between the layouts: :func:`load_gathered_checkpoint` cuts a rank's
blocks from a gathered file, and :func:`stitch_rank_checkpoints` joins a
run's rank files into one.  :func:`load_grid_checkpoint` is the
trainer's ``--resume`` under torchrun: the rank files when any is
there, else the gathered file, never both.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import zipfile
from itertools import chain
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import block_index, block_of, spec_axes
from repro_torch.utils.tree import (keystr_path, tree_leaves_with_path,
                                    tree_unflatten)

# the leaves of ``comp_state`` each node holds for itself (its EF
# residuals); the rest of the train state is its model shard's
NODE_LEAVES = ("u", "v")
DP_AXES = ("pod", "data")
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


def _as_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a CPU tensor over its memory (bf16 bits for a 2-byte
    void entry read into a bf16 leaf)."""
    if arr.dtype == np.dtype("V2") and like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _write(path: str, items: Iterable[Tuple[str, np.ndarray]]) -> None:
    """The (key, array) pairs as an .npz at ``path``, the entries
    ``np.savez`` writes, each converted and written in turn: a temporary
    file, renamed."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, arr in items:
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(arr),
                                              allow_pickle=False)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(path: str, tree: Any, step: int) -> None:
    _write(path, chain(
        ((keystr_path(p), _to_numpy(leaf))
         for p, leaf in tree_leaves_with_path(tree)),
        [("__step__", np.asarray(step, np.int64))]))


def _entry(z, key: str, shape: Tuple[int, ...], path: str, n_keys: int
           ) -> np.ndarray:
    """The npz ``z``'s entry ``key``, of ``shape``, or CheckpointError."""
    if key not in z.files:
        raise CheckpointError(
            f"{path}: missing entry {key!r} — this checkpoint predates the "
            f"full-state (params, opt_state, comp_state) format or belongs "
            f"to a different model/config (it has {len(z.files) - 1} "
            f"entries; the template needs {n_keys})")
    arr = z[key]
    if arr.shape != tuple(shape):
        raise CheckpointError(
            f"{path}: shape mismatch at {key!r}: checkpoint has "
            f"{tuple(arr.shape)}, template expects {tuple(shape)}")
    return arr


def _step_of(z, path: str) -> int:
    if "__step__" not in z.files:
        raise CheckpointError(f"{path}: no '__step__' entry — not a "
                              f"checkpoint written by save_checkpoint")
    return int(z["__step__"])


def load_checkpoint(path: str, template: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``template``, each leaf in the
    template leaf's dtype and on its device; returns (tree, step).
    Raises :class:`CheckpointError` when the file has no ``__step__``,
    misses a template key, or holds another shape."""
    flat = tree_leaves_with_path(template)
    with np.load(path) as z:
        step = _step_of(z, path)
        leaves = [_as_tensor(_entry(z, keystr_path(p), leaf.shape, path,
                                    len(flat)), leaf)
                  .to(device=leaf.device, dtype=leaf.dtype)
                  for p, leaf in flat]
    return tree_unflatten(template, leaves), step


# -- the grid: specs, coordinates, blocks ------------------------------------


def _spec_to_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_json(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def node_specs(keys: Iterable[str], Ks: Sequence[int]) -> Dict[str, tuple]:
    """The LGC state's specs with no model axis: ``comp_state``'s u and v
    over (dp, "model", None), every other leaf whole."""
    dp = "data" if len(Ks) == 1 else DP_AXES
    node = {f"comp_state/{k}" for k in NODE_LEAVES}
    return {k: (dp, "model", None) if k in node else () for k in keys}


def grid_coords(Ks: Sequence[int], node: int, shard: int) -> Dict[str, int]:
    """{pod, data, model} of dp node ``node`` (row-major over the dp mesh
    ``Ks``) and model shard ``shard``; pod 0 without a pod axis."""
    c = [int(x) for x in np.unravel_index(node, tuple(Ks))]
    pod, data = c if len(c) == 2 else (0, c[0])
    return {"pod": pod, "data": data, "model": int(shard)}


def grid_sizes(Ks: Sequence[int], model: int) -> Dict[str, int]:
    return {"pod": int(Ks[0]) if len(Ks) == 2 else 1, "data": int(Ks[-1]),
            "model": int(model)}


def writes(spec, coords: Dict[str, int]) -> bool:
    """Whether the rank at ``coords`` writes its block of a leaf of
    ``spec``: 0 on every dp axis the spec does not split."""
    split = spec_axes(spec)
    return all(coords.get(a, 0) == 0 for a in DP_AXES if a not in split)


def _whole_shape(shape, spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The gathered leaf's shape of a block of ``shape`` under ``spec``."""
    out = list(shape)
    for d, (_, n) in enumerate(block_index(spec, {}, sizes)):
        out[d] *= n
    return tuple(out)


# -- one file a rank ----------------------------------------------------------


def rank_path(path: str, rank: int) -> str:
    """Rank ``rank``'s file of the checkpoint ``path`` saved one file a
    rank: ``<dir>/ckpt.npz`` -> ``<dir>/ckpt.rank<rank>.npz``."""
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext or '.npz'}"


def save_rank_checkpoint(path: str, tree: Any, step: int,
                         Ks: Sequence[int], node: int, model: int = 1,
                         shard: int = 0,
                         specs: Optional[Dict[str, tuple]] = None) -> None:
    """The file of dp node ``node``, model shard ``shard`` of the grid
    (``Ks``, ``model``) at ``rank_path(path, node·model + shard)``: the
    leaves of this rank's state ``tree`` (its blocks, keyed as the
    gathered file) that it :func:`writes` under ``specs`` ({key: spec};
    None: :func:`node_specs`), and the header.  No collective: each
    process saves on its own."""
    flat = [(keystr_path(p), leaf) for p, leaf in tree_leaves_with_path(tree)]
    specs = node_specs([k for k, _ in flat], Ks) if specs is None else specs
    coords = grid_coords(Ks, node, shard)
    header = [
        ("__step__", np.asarray(step, np.int64)),
        ("__mesh__", np.asarray(tuple(Ks), np.int64)),
        ("__node__", np.asarray(node, np.int64)),
        ("__model__", np.asarray((model, shard), np.int64)),
        ("__specs__", np.asarray(json.dumps(
            {k: _spec_to_json(specs[k]) for k, _ in flat})))]
    _write(rank_path(path, node * model + shard), chain(
        ((k, _to_numpy(leaf)) for k, leaf in flat if writes(specs[k], coords)),
        header))


def read_rank_header(path: str, rank: int) -> Dict[str, Any]:
    """What rank ``rank``'s file of ``path`` says of itself: {"file",
    "step", "mesh", "node", "model": [model shards, shard]}, or {"file",
    "error"} when it is missing or is not a rank file."""
    f = rank_path(path, rank)
    try:
        with np.load(f) as z:
            return {"file": f, "step": int(z["__step__"]),
                    "mesh": [int(k) for k in z["__mesh__"]],
                    "node": int(z["__node__"]),
                    "model": [int(k) for k in z["__model__"]]}
    except FileNotFoundError:
        return {"file": f, "error": "missing"}
    except _UNREADABLE as e:
        return {"file": f, "error": f"not a rank file ({type(e).__name__}: "
                                    f"{e})"}


def _grid_name(mesh, model: int) -> str:
    return f"{tuple(mesh)}" + (f" x model {model}" if model != 1 else "")


def _rank_name(node: int, shard: int, model: int) -> str:
    return f"node {node}" + (f" model shard {shard}" if model != 1 else "")


def check_rank_headers(headers: List[Dict[str, Any]], Ks: Sequence[int],
                       model: int = 1) -> int:
    """The step the files of the grid (``Ks``, ``model``) resume at
    (``headers[r]``, rank r's, as :func:`read_rank_header` gives them).
    Raises :class:`CheckpointError` naming the files unless every file is
    there, readable, saved on that grid by its own rank, and all at one
    step (files at two steps are a torn save: a crash between two
    processes' renames)."""
    Ks = [int(k) for k in Ks]
    problems = []
    for r, h in enumerate(headers):
        node, shard = divmod(r, model)
        if "error" in h:
            problems.append(f"{h['file']}: {h['error']}")
        elif (h["mesh"], h["model"][0]) != (Ks, model):
            problems.append(f"{h['file']}: saved on the mesh "
                            f"{_grid_name(h['mesh'], h['model'][0])}, not "
                            f"{_grid_name(Ks, model)}")
        elif (h["node"], h["model"][1]) != (node, shard):
            problems.append(
                f"{h['file']}: {_rank_name(h['node'], h['model'][1], model)}"
                f"'s, not {_rank_name(node, shard, model)}'s")
    steps = sorted({h["step"] for h in headers if "step" in h})
    if len(steps) > 1:
        problems.append("a torn save, files of steps " + ", ".join(
            f"{h['file']} at {h['step']}" for h in headers if "step" in h))
    if problems:
        raise CheckpointError("cannot resume from the rank files: "
                              + "; ".join(problems))
    return steps[0]


def _world_gather(obj) -> list:
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _source_group(grid, unsplit: Sequence[str]):
    """The group over the dp axes ``unsplit`` through this rank (None
    when there are none): its member 0 holds the leaf."""
    if not unsplit:
        return None
    if "pod" in unsplit and "data" in unsplit:
        return grid.dp
    return grid.data if "data" in unsplit else grid.pod


def load_rank_checkpoint(path: str, template: Any, grid,
                         specs: Optional[Dict[str, tuple]] = None
                         ) -> Tuple[Any, int]:
    """Resume from ``path``'s rank files: a collective, every rank of
    ``grid`` (a ``launch.mesh.ProcessGrid``) calls it.  Each reads the
    leaves it :func:`writes` from its own file into ``template``'s
    structure (its blocks, keyed as the gathered file; ``specs`` as
    saved), the ranks exchange what their files hold, and each other
    leaf arrives, bit for bit, from the member of this rank's dp column
    at 0 on the leaf's unsplit dp axes.  Returns (tree, step); every rank
    raises the same :class:`CheckpointError` when any file is missing,
    unreadable, of another grid, rank or step, so none waits for another
    and none trains."""
    Ks = grid.pm.Ks
    model = grid.spec.axis_sizes.get("model", 1)
    flat = [(keystr_path(p), leaf)
            for p, leaf in tree_leaves_with_path(template)]
    specs = node_specs([k for k, _ in flat], Ks) if specs is None else specs
    header = read_rank_header(path, grid.rank)
    own: Dict[str, torch.Tensor] = {}
    if "error" not in header:
        try:
            with np.load(header["file"]) as z:
                for key, leaf in flat:
                    if writes(specs[key], grid.coords):
                        own[key] = _as_tensor(_entry(
                            z, key, leaf.shape, header["file"], len(flat)),
                            leaf).to(device=leaf.device, dtype=leaf.dtype)
        except _UNREADABLE as e:        # CheckpointError included
            header, own = {"file": header["file"], "error": str(e)}, {}
    step = check_rank_headers(_world_gather(header), Ks, model)
    dp = [a for a in DP_AXES if a in grid.spec.axis_sizes]
    leaves = []
    for key, leaf in flat:
        split = spec_axes(specs[key])
        group = _source_group(grid, [a for a in dp if a not in split])
        x = own.get(key, leaf)
        leaves.append(x if group is None else _broadcast_bits(group, x))
    return tree_unflatten(template, leaves), step


def _broadcast_bits(group, x: torch.Tensor) -> torch.Tensor:
    """Member 0's ``x`` on every member of ``group`` (a ``dist.tp.Group``),
    moved as its bytes (any dtype)."""
    if x.numel() == 0:
        return x
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    return group.broadcast(flat, 0).view(x.dtype).view(x.shape)


# -- between the layouts ------------------------------------------------------


def load_gathered_checkpoint(path: str, template: Any,
                             specs: Dict[str, tuple], coords: Dict[str, int],
                             sizes: Dict[str, int]) -> Tuple[Any, int]:
    """A rank's blocks from the gathered file ``path`` (the reference
    trainer's ``ckpt.npz`` or the emulated trainer's): each leaf of
    ``template`` (the rank's blocks, keyed as the file) cut from the
    file's leaf under ``specs[key]`` at ``coords`` on a mesh of
    ``sizes`` (``dist.sharding.block_of``; u and v: [d, m], d the flat dp
    index pod·K_data + data), in the template leaf's dtype and on its
    device.  The file is read one leaf at a time: a rank holds at most
    one whole leaf beyond its blocks.  Returns (tree, step); no
    collective."""
    flat = tree_leaves_with_path(template)
    leaves = []
    with np.load(path) as z:
        step = _step_of(z, path)
        for p, leaf in flat:
            key = keystr_path(p)
            spec = specs[key]
            whole = _as_tensor(_entry(z, key, _whole_shape(
                leaf.shape, spec, sizes), path, len(flat)), leaf)
            leaves.append(block_of(whole, spec, coords, sizes).to(
                device=leaf.device, dtype=leaf.dtype, copy=True))
            del whole
    return tree_unflatten(template, leaves), step


def stitch_rank_checkpoints(path: str, out: str) -> None:
    """Join the rank files of ``path`` into the gathered file ``out``:
    the reference trainer's keys and ``__step__``, nothing else, each
    leaf whole, written one at a time.  A leaf whole over ``model`` is
    model shard 0's copy, as the reference's save takes device 0's; so a
    resume from the stitched file follows the reference's resumed run,
    which hands every model shard that copy, not the uninterrupted run,
    which a resume from the rank files continues.  Raises
    :class:`CheckpointError` as :func:`check_rank_headers` does."""
    first = read_rank_header(path, 0)
    if "error" in first:
        raise CheckpointError(f"{first['file']}: {first['error']}")
    Ks, model = first["mesh"], first["model"][0]
    world = math.prod(Ks) * model
    step = check_rank_headers([read_rank_header(path, r)
                               for r in range(world)], Ks, model)
    sizes = grid_sizes(Ks, model)
    coords = [grid_coords(Ks, *divmod(r, model)) for r in range(world)]
    files = [np.load(rank_path(path, r)) for r in range(world)]
    try:
        specs = json.loads(str(files[0]["__specs__"]))

        def gathered(key, spec):
            split = spec_axes(spec)
            holders = [r for r, c in enumerate(coords)
                       if all(c[a] == 0 for a in c if a not in split)]
            whole = None
            for r in holders:
                if key not in files[r].files:
                    raise CheckpointError(f"{rank_path(path, r)}: no entry "
                                          f"{key!r}")
                block = files[r][key]
                if whole is None:
                    whole = np.empty(_whole_shape(block.shape, spec, sizes),
                                     block.dtype)
                whole[tuple(slice(i * w, (i + 1) * w) for (i, _), w in zip(
                    block_index(spec, coords[r], sizes), block.shape))] = \
                    block
            return whole
        _write(out, chain(
            ((key, gathered(key, _spec_from_json(spec)))
             for key, spec in specs.items()),
            [("__step__", np.asarray(step, np.int64))]))
    finally:
        for f in files:
            f.close()


def load_grid_checkpoint(path: str, template: Any, grid,
                         specs: Dict[str, tuple]) -> Tuple[Any, int, str]:
    """``--resume path`` on ``grid``: (tree, step, the layout read, "rank
    files" or "gathered").  The rank files when any rank sees its own
    (:func:`load_rank_checkpoint`: all must be there), else the gathered
    file (:func:`load_gathered_checkpoint`); a collective, and every rank
    raises the same :class:`CheckpointError` when both kinds are there,
    or when any rank cannot read the gathered file."""
    seen = _world_gather((os.path.exists(rank_path(path, grid.rank)),
                          os.path.exists(path)))
    ranked = [rank_path(path, r) for r, (mine, _) in enumerate(seen) if mine]
    if ranked and any(g for _, g in seen):
        raise CheckpointError(
            f"both the gathered checkpoint {path} and rank files "
            f"({', '.join(ranked)}) are there: remove one")
    if ranked:
        return load_rank_checkpoint(path, template, grid, specs) + (
            "rank files",)
    tree, step, error = None, None, None
    try:
        tree, step = load_gathered_checkpoint(
            path, template, specs, grid.coords, grid.spec.axis_sizes)
    except _UNREADABLE as e:
        error = f"{type(e).__name__}: {e}"
    errors = sorted({e for e in _world_gather(error) if e})
    if errors:
        raise CheckpointError("cannot resume from the gathered file: "
                              + "; ".join(errors))
    return tree, step, "gathered"
