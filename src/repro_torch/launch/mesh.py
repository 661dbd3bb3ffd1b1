"""Meshes (counterpart of ``repro.launch.mesh``): the descriptions the
placement rules and the dry run read, and the process layout of a run
under ``torchrun``, one LGC node per process.

A :class:`MeshSpec` is a mesh's axis names and sizes, without devices:
``production_mesh`` gives the reference's 256- and 512-chip meshes,
``host_mesh`` a small one, and ``dp_axes_of``, ``dp_size_of`` and
``model_size_of`` read them as the reference reads a device mesh.

torchrun sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; the mesh is
(pod, data, model) in the row-major order of ``jax.make_mesh``'s devices
(rank r holds device r's coordinates: node ia·K_data + i1 and model shard
m are rank (ia·K_data + i1)·model + m), and ``WORLD_SIZE`` must be pod x
data x model (:class:`ProcessGrid`).
Rank r runs on ``cuda:(LOCAL_RANK mod device_count)`` unless it is asked
for the CPU, so K processes may share one card; without a card every rank
raises.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --data-shards 2 --dist-backend gloo ...
"""
from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.p2p import ProcessMesh
from repro_torch.dist.tp import Group
from repro_torch.utils import resolve_device

BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and their sizes, in order; no devices."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} for a shape "
                             f"{self.shape}")

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def production_mesh(multi_pod: bool = False) -> MeshSpec:
    """One pod: (data=16, model=16), 256 chips; two pods: (pod=2, data=16,
    model=16), 512 chips."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def host_mesh(data: int = 1, model: int = 1, pod: int = 1) -> MeshSpec:
    """(data, model), or (pod, data, model) when ``pod`` > 1, whose dp
    axes are then ("pod", "data")."""
    if pod > 1:
        return MeshSpec(("pod", "data", "model"), (pod, data, model))
    return MeshSpec(("data", "model"), (data, model))


def dp_axes_of(mesh: MeshSpec) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_size_of(mesh: MeshSpec) -> int:
    return mesh.axis_sizes.get("model", 1)


def dp_size_of(mesh: MeshSpec) -> int:
    sizes = mesh.axis_sizes
    return sizes.get("pod", 1) * sizes.get("data", 1)


def under_torchrun() -> bool:
    """Whether this process is one rank of a launch (torchrun's
    environment)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def layout_from_env(Ks: Sequence[int], model: int = 1):
    """(rank, world size, local rank) from torchrun's environment; raises
    unless the world holds exactly the mesh's pod x data x model
    processes."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    K = math.prod(Ks)
    if world != K * model:
        raise ValueError(
            f"WORLD_SIZE={world} processes for a dp mesh {tuple(Ks)} of {K} "
            f"nodes x {model} model shards: launch pod-shards x data-shards "
            f"x model-shards processes, one per shard")
    return rank, world, local


def rank_device(kind: str, local_rank: int) -> torch.device:
    """``cuda:(local_rank mod device_count)`` (ranks beyond the cards share
    them), or the CPU when asked; raises without a card."""
    if kind == "cpu":
        return torch.device("cpu")
    resolve_device(kind)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


@dataclass(eq=False)
class ProcessGrid:
    """This process's place in a launch's (pod, data, model) mesh, rank
    r at the coordinates of ``jax.make_mesh``'s device r (row-major):
    ``pm``, its model shard's dp column as a ``ProcessMesh`` (the LGC
    step's wire); ``model``, the model group of its dp coordinate;
    ``dp``, its column (pod and data); ``data``, the data group of its
    (pod, model); ``pod``, the pod group of its (data, model)."""
    spec: MeshSpec
    rank: int
    coords: Dict[str, int]
    device: torch.device
    pm: ProcessMesh
    model: Group
    dp: Group
    data: Group
    pod: Group

    @property
    def backend(self) -> str:
        return self.pm.backend

    def groups(self) -> Dict[str, Group]:
        """{axis: group} for ``dist.sharding.gather_tree``."""
        return {"pod": self.pod, "data": self.data, "model": self.model}


def _axis_groups(world, axis: int, rank: int, device) -> Group:
    """Every line of ``axis`` through the rank grid ``world`` as a group
    (each rank creates all, in row-major order of the other axes); this
    rank's."""
    mine = None
    size = world.shape[axis]
    for line in np.moveaxis(world, axis, -1).reshape(-1, size):
        ranks = [int(r) for r in line]
        group = dist.new_group(ranks) if size > 1 else None
        if rank in ranks:
            mine = (ranks, group)
    return Group(mine[0], mine[1], device)


def init_process_mesh(Ks: Sequence[int], backend: Optional[str],
                      device_kind: str, init_method: str = "env://",
                      timeout_s: float = 1800.0, model: int = 1
                      ) -> ProcessGrid:
    """Join the launch's process group and build the (pod, data, model)
    process grid: every rank creates every group in the same order (the
    dp columns and their rings, then the model, data and pod groups).
    ``backend`` is gloo or nccl, chosen by the caller (NCCL needs a card
    per rank)."""
    if backend not in BACKENDS:
        raise ValueError(f"a run under torchrun needs --dist-backend, one "
                         f"of {BACKENDS}; got {backend!r}")
    rank, world, local = layout_from_env(Ks, model)
    device = rank_device(device_kind, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    pm = ProcessMesh(Ks, device, model)
    Ks = tuple(Ks)
    pod, data = (Ks if len(Ks) == 2 else (1,) + Ks)
    spec = host_mesh(data, model, pod)
    grid = np.arange(world).reshape(pod, data, model)
    coords = dict(zip(("pod", "data", "model"),
                      (int(c) for c in np.unravel_index(rank, grid.shape))))
    groups = [_axis_groups(grid, a, rank, device) for a in (2, 1, 0)]
    return ProcessGrid(spec, rank, coords, device, pm, groups[0],
                       Group(pm.ranks, pm.group, device), groups[1],
                       groups[2])
