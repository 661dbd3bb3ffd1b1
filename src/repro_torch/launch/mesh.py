"""The process layout of a run under ``torchrun`` (counterpart of
``repro.launch.mesh``): one LGC node per process.

torchrun sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; the dp mesh is
(pod, data) in the reference's row-major order, node ia·K_data + i1 the
process of rank ia·K_data + i1, and ``WORLD_SIZE`` must be pod x data.
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
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.p2p import ProcessMesh
from repro_torch.utils import resolve_device

BACKENDS = ("gloo", "nccl")


def under_torchrun() -> bool:
    """Whether this process is one rank of a launch (torchrun's
    environment)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def layout_from_env(Ks: Sequence[int]):
    """(rank, world size, local rank) from torchrun's environment; raises
    unless the world holds exactly the mesh's pod x data nodes."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    K = math.prod(Ks)
    if world != K:
        raise ValueError(
            f"WORLD_SIZE={world} processes for a dp mesh {tuple(Ks)} of {K} "
            f"nodes: launch pod-shards x data-shards processes, one per "
            f"node")
    return rank, world, local


def rank_device(kind: str, local_rank: int) -> torch.device:
    """``cuda:(local_rank mod device_count)`` (ranks beyond the cards share
    them), or the CPU when asked; raises without a card."""
    if kind == "cpu":
        return torch.device("cpu")
    resolve_device(kind)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_process_mesh(Ks: Sequence[int], backend: Optional[str],
                      device_kind: str, init_method: str = "env://",
                      timeout_s: float = 1800.0) -> ProcessMesh:
    """Join the launch's process group and build the (pod, data) process
    mesh: every rank creates the mesh's groups in the same order.
    ``backend`` is gloo or nccl, chosen by the caller (NCCL needs a card
    per rank)."""
    if backend not in BACKENDS:
        raise ValueError(f"a run under torchrun needs --dist-backend, one "
                         f"of {BACKENDS}; got {backend!r}")
    rank, world, local = layout_from_env(Ks)
    device = rank_device(device_kind, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return ProcessMesh(Ks, device)
