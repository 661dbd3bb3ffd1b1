"""Tensor parallelism and FSDP across processes: explicit, autograd-aware
collectives on local shards (Megatron-style), the collectives that the
reference's GSPMD derives from its ``PartitionSpec``s.

A :class:`Group` is one process group of a launch's (pod, data, model)
mesh with where this process's tensors live.  With the gloo backend and
CUDA tensors every message goes through a pinned host buffer (gloo's
collectives move host memory), as ``dist.p2p.ProcessMesh`` stages its
messages; with NCCL the card's tensors go directly.  A group of one
process moves nothing.

The autograd functions, each on a group:

- :func:`copy_to` before a column-parallel matmul: forward identity,
  backward the all-reduce (sum) of the gradient over the group;
- :func:`reduce_from` after a row-parallel matmul: forward the
  all-reduce (sum), backward identity;
- :func:`gather_dim` FSDP's gather on use, and the blocks of a head
  that the model shards cut (k, v, the query heads' outputs), which each
  member then reads its own part of: forward the all-gather of a dim,
  backward the reduce-scatter (sum) of its gradient, so the members'
  parts are summed;
- :func:`gather_from` after a column-parallel matmul whose gathered
  output every member then computes on identically (a router's logits,
  a latent before its norm, a Mamba2 block's ``in_proj``): forward the
  all-gather of a dim, backward this member's block of the gradient,
  which is whole on every member (a reduce-scatter would count it
  group-size times);
- :func:`sum_over` forward the all-reduce (sum), backward the
  all-reduce (sum): a sum every member reads the same way (the MoE
  aux's per-expert sums over the batch), each member's loss holding
  its share;
- :func:`all_reduce_max` (no gradient), the vocab-parallel softmax's max.

:class:`Shards` is what a sharded forward of ``models.model.Model``
reads: the model group, the data group of FSDP's gather on use with the
param specs that say which dims it gathers, the data group of a decode
cache split along the sequence, and the group over which one loss's
batch is split.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import dims_over
from repro_torch.utils.tree import (keystr_path, tree_leaves_with_path,
                                    tree_unflatten)


class Group:
    """A process group over the global ``ranks`` (in group order), this
    process's index in it, and ``device``, where its tensors live."""

    def __init__(self, ranks: Sequence[int], group, device):
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.device = torch.device(device)
        self.nccl = dist.get_backend(group) == "nccl"
        self.stage = self.device.type == "cuda" and not self.nccl

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh contiguous buffer holding ``x`` where the backend reads
        it."""
        if self.stage:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            return host
        return x.contiguous().clone()

    def _back(self, buf: torch.Tensor) -> torch.Tensor:
        return buf.to(self.device, non_blocking=True) if self.stage else buf

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        if self.size == 1:
            return x
        buf = self._wire(x)
        dist.all_reduce(buf, op=op, group=self.group)
        return self._back(buf)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every member's ``x`` concatenated along ``dim``, in group
        order."""
        if self.size == 1:
            return x
        buf = self._wire(x)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return self._back(torch.cat(parts, dim))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's sum of ``x``, this member's block of ``dim``."""
        if self.size == 1:
            return x
        w = x.shape[dim] // self.size
        if self.nccl:
            src = x.movedim(dim, 0).contiguous()
            out = src.new_empty((w,) + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(out, src, group=self.group)
            return out.movedim(0, dim)
        return self.all_reduce(x).narrow(dim, self.index * w, w).contiguous()

    def broadcast(self, x: torch.Tensor, index: int = 0) -> torch.Tensor:
        """Member ``index``'s ``x`` on every member."""
        if self.size == 1:
            return x
        buf = self._wire(x)
        dist.broadcast(buf, src=self.ranks[index], group=self.group)
        return self._back(buf)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.width
        return grad.narrow(ctx.dim, ctx.group.index * w, w).contiguous(), \
            None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad), None


def _active(group: Optional[Group]) -> bool:
    return group is not None and group.size > 1


def copy_to(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return _Copy.apply(x, group) if _active(group) else x


def reduce_from(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return _Reduce.apply(x, group) if _active(group) else x


def gather_dim(x: torch.Tensor, group: Optional[Group], dim: int
               ) -> torch.Tensor:
    return _Gather.apply(x, group, dim) if _active(group) else x


def gather_from(x: torch.Tensor, group: Optional[Group], dim: int
                ) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim) if _active(group) else x


def sum_over(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return _SumOver.apply(x, group) if _active(group) else x


def all_reduce_max(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    x = x.detach()
    return group.all_reduce(x, dist.ReduceOp.MAX) if _active(group) else x


@dataclass(eq=False)
class Shards:
    """A sharded forward's collectives.  ``model``: the group over which
    the heads, the FFN's hidden dim, the experts and the vocabulary are
    split (TP); ``fsdp``: the data group that gathers every dim whose
    spec in ``specs`` ({path: spec} of the params the forward receives)
    names ``"data"``; ``seq``: the data group over which a decode cache
    is split along the sequence (rank i holding slots [i·S/n,
    (i+1)·S/n)), or over its other dim 2 (the encoder tokens of a cross
    cache, a Mamba2 state's heads or its conv state's rows); ``batch``:
    the dp group over which the batch of one loss is split, member i
    holding its i-th block of rows (the auto step, serving with the batch
    over data): MoE's dispatch groups, its aux loss's means and the token
    counts are the whole batch's."""
    model: Optional[Group] = None
    fsdp: Optional[Group] = None
    specs: Dict[str, tuple] = field(default_factory=dict)
    seq: Optional[Group] = None
    batch: Optional[Group] = None
    # the dp size whose divisibility the reference's cache rule checks
    # (pod x data: over pods the cache is split over data, held whole over
    # pod); 0 = the size of ``seq``
    seq_dp: int = 0

    @property
    def mp(self) -> int:
        return self.model.size if self.model is not None else 1

    @property
    def m(self) -> int:
        return self.model.index if self.model is not None else 0

    def copy(self, x):
        return copy_to(x, self.model)

    def reduce(self, x):
        return reduce_from(x, self.model)

    def gather(self, x, dim: int = -1):
        return gather_from(x, self.model, dim % x.dim())

    @property
    def nb(self) -> int:
        """The members the loss's batch is split over."""
        return self.batch.size if _active(self.batch) else 1

    def _data_dims(self, path: str):
        return dims_over(self.specs.get(path, ()), "data")

    def leaf(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` (the leaf at ``path``) with its data-sharded dims
        gathered."""
        if not _active(self.fsdp):
            return x
        for d in self._data_dims(path):
            x = gather_dim(x, self.fsdp, d)
        return x

    def block(self, blocks, i: int):
        """Superblock i of the stacked ``blocks`` tree, each leaf sliced
        to block i, then its data-sharded dims gathered (a sharded
        leading block dim is gathered before the slice)."""
        leaves = []
        for path, x in tree_leaves_with_path(blocks):
            dims = self._data_dims("blocks/" + keystr_path(path)) \
                if _active(self.fsdp) else []
            if 0 in dims:
                x = gather_dim(x, self.fsdp, 0)
            x = x[i]
            for d in dims:
                if d:
                    x = gather_dim(x, self.fsdp, d - 1)
            leaves.append(x)
        return tree_unflatten(blocks, leaves)
