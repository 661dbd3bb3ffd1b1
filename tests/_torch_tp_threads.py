"""Threads standing in for the processes of one launch, in this
process: each thread a shard of ``Model(cfg, Shards(model=...))`` whose
group swaps its tensors with the others through a barrier, so a sharded
step runs without a process group and is held to the one-process
model on the same params and batch.

    got, want = shards_and_one_process(cfg, mp, params, batch)

Or each thread a rank of a (pod, data, model) grid (``thread_grids``:
what ``launch.mesh.init_process_mesh`` returns, its groups threads), on
which the step builders of ``launch.steps`` and the server run as they
do under torchrun:

    outs = run_ranks(lambda grid: ..., thread_grids(pod, data, model))
"""
import threading
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import sharding as SH
from repro_torch.dist.tp import Shards
from repro_torch.launch.mesh import host_mesh
from repro_torch.models.model import Model, build_model
from repro_torch.utils.tree import tree_leaves, tree_unflatten


class ThreadGroup:
    """Member ``index`` of a group of threads sharing ``board`` (a
    barrier and one slot a member): the ``dist.tp.Group`` collectives a
    sharded forward and backward call."""

    def __init__(self, board, index):
        self.board, self.index = board, index
        self.size = len(board[1])

    def all_gather(self, x, dim):
        barrier, slots = self.board
        slots[self.index] = x.clone()
        barrier.wait()
        y = torch.cat(list(slots), dim)
        barrier.wait()
        return y

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        parts = self.all_gather(x[None], 0)
        return parts.amax(0) if op == dist.ReduceOp.MAX else parts.sum(0)

    def reduce_scatter(self, x, dim):
        w = x.shape[dim] // self.size
        return self.all_reduce(x).narrow(dim, self.index * w, w).contiguous()

    def broadcast(self, x, index=0):
        return self.all_gather(x[None], 0)[index]


def _board(n):
    return (threading.Barrier(n), [None] * n)


def thread_grids(pod, data, model, device="cpu"):
    """One stand-in of ``launch.mesh.ProcessGrid`` a rank of the (pod,
    data, model) mesh, rank r at its row-major coordinates: its
    ``model``, ``data``, ``pod`` and ``dp`` (pod x data, node order)
    groups are ``ThreadGroup``s over the threads of its lines, ``pm``
    names its node of K = pod x data; run them with ``run_ranks``."""
    world = np.arange(pod * data * model).reshape(pod, data, model)
    lines = {}
    for name, axes in (("pod", (0,)), ("data", (1,)), ("model", (2,)),
                       ("dp", (0, 1))):
        rest = [a for a in range(3) if a not in axes]
        for line in np.moveaxis(world, rest, list(range(len(rest)))).reshape(
                int(np.prod([world.shape[a] for a in rest])), -1):
            board = _board(len(line))
            for i, r in enumerate(line):
                lines[(name, int(r))] = ThreadGroup(board, i)
    grids = []
    for r in range(world.size):
        p, d, m = (int(c) for c in np.unravel_index(r, world.shape))
        grids.append(SimpleNamespace(
            spec=host_mesh(data, model, pod), rank=r,
            coords={"pod": p, "data": d, "model": m},
            device=torch.device(device),
            pm=SimpleNamespace(K=pod * data, node=p * data + d),
            **{name: lines[(name, r)]
               for name in ("model", "dp", "data", "pod")}))
    return grids


def run_ranks(fn, grids, timeout=300):
    """``fn(grid)`` on a thread a rank of ``thread_grids``; returns each
    rank's result, or raises the first error (the other ranks' barriers
    broken)."""
    out, errors = [None] * len(grids), []
    barriers = {id(g.board[0]): g.board[0] for grid in grids
                for g in (grid.model, grid.dp, grid.data, grid.pod)}

    def rank(r):
        try:
            out[r] = fn(grids[r])
        except BaseException as e:       # the others wait on a barrier
            errors.append(e)
            for b in barriers.values():
                b.abort()
    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(len(grids))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[0]
    return out


def _grads(model, params, batch):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in tree_leaves(params)]
    loss, metrics = model.loss(tree_unflatten(params, leaves), batch)
    return loss.detach(), list(torch.autograd.grad(loss, leaves)), {
        k: v.detach() for k, v in metrics.items()}


def _serve(model, params, batch, cache_len: int):
    """The prefill's and one decode step's logits."""
    prompt = {k: x for k, x in batch.items() if k != "labels"}
    logits, cache = model.prefill(params, prompt, cache_len=cache_len)
    tok = logits[:, -1].argmax(-1)[:, None]
    step, cache = model.decode_step(params, cache, tok,
                                    batch["tokens"].shape[1])
    return logits, step, cache


def shards_and_one_process(cfg, mp: int, full, batch):
    """Each of ``mp`` model shards' (loss, metrics, gradient blocks,
    prefill and decode logits, its cache), and one process's (loss,
    metrics, the gradient cut into each shard's blocks, the logits); the
    params cut by ``param_pspecs`` at model size ``mp``."""
    specs = SH.param_pspecs(full, model_size=mp)
    sizes = {"model": mp}
    S = batch["tokens"].shape[1]
    one = build_model(cfg)
    loss, grads, metrics = _grads(one, full, batch)
    logits, step, _ = _serve(one, full, batch, S + 1)
    grads = tree_unflatten(full, grads)
    want = {"loss": loss, "metrics": metrics, "logits": logits, "step": step,
            "grads": [tree_leaves(SH.shard_tree(grads, specs, {"model": m},
                                                sizes)) for m in range(mp)]}
    board = (threading.Barrier(mp), [None] * mp)
    got, errors = [None] * mp, []

    def shard(m):
        try:
            model = Model(cfg, Shards(model=ThreadGroup(board, m),
                                      specs=specs))
            local = SH.shard_tree(full, specs, {"model": m}, sizes)
            loss, grads, metrics = _grads(model, local, batch)
            logits, step, cache = _serve(model, local, batch, S + 1)
            got[m] = {"loss": loss, "metrics": metrics, "grads": grads,
                      "logits": logits, "step": step, "cache": cache}
        except BaseException as e:       # the others wait on the barrier
            errors.append(e)
            board[0].abort()
    threads = [threading.Thread(target=shard, args=(m,))
               for m in range(mp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors:
        raise errors[0]
    return got, want
