"""The LGC training step (counterpart of
``repro.launch.steps.make_lgc_train_step``), with the K nodes emulated on
one device or one node per process.

Emulated, per step: K per-node gradients (the reference vmaps over the
node axis; here a loop over nodes), flattened into a (K, n) f32 buffer in
the reference's leaf order, ``GradientCompressor.sim_step``, unflatten,
the optimizer.  Under a process mesh (``mesh``), process r is node r: it
takes batch rows [r·B/K, (r+1)·B/K), as ``node_grads`` gives node r, and
runs its gradient, ``GradientCompressor.dist_step`` and the optimizer on
its own replica; the logged metrics are the node mean of every node's,
gathered, in the emulated order, so its loss is the emulated run's bit
for bit.  No gradient all-reduce happens anywhere else: the compressor's
exchange is the whole cross-node traffic.

:func:`sim_sgd_step` is the same step for any loss, with plain SGD: the
reference's own single-host ConvNet5 loop (``tests/test_system.py``'s
``test_convnet5_paper_model_trains``), which has no trainer entry point.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.compressors import GradientCompressor, build_compressor
from repro_torch.core.phases import phase_for_step
from repro_torch.dist.p2p import ProcessMesh
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer, build_optimizer
from repro_torch.utils.tree import (tree_leaves, tree_map, tree_unflatten,
                                    tree_unflatten_vector)


@dataclass
class LGCTrainStep:
    model: Model
    compressor: GradientCompressor
    optimizer: Optimizer
    device: torch.device
    mesh: Optional[ProcessMesh] = None     # one node per process

    @property
    def K(self) -> int:
        return self.compressor.K

    def init(self, gen: torch.Generator):
        """Params, optimizer state and the compressor's: the K nodes' (K,
        n) accumulators, or under a process mesh this node's (n,).  Every
        process draws the same params and AE from the same seed."""
        params = self.model.init(gen, self.device)
        opt_state = self.optimizer.init(params)
        comp_state = self.compressor.init_sim_states(gen, self.device) \
            if self.mesh is None else \
            self.compressor.init_state(gen, self.device)
        return params, opt_state, comp_state

    def node_grads(self, params, batch: Dict[str, torch.Tensor]):
        """(K, n) f32 per-node gradients and the node-mean metrics."""
        return node_grads(self.model.loss, params, batch, self.K,
                          self.compressor.layout.n_total)

    @torch.no_grad()
    def step(self, params, opt_state, comp_state, batch, step: int,
             phase: str):
        if self.mesh is None:
            g_nodes, metrics = self.node_grads(params, batch)
            g_global, comp_state, stats = self.compressor.sim_step(
                comp_state, g_nodes, step, phase)
        else:
            g_nodes, per_node = grads_of_nodes(
                self.model.loss, params, batch, self.K,
                self.compressor.layout.n_total, (self.mesh.node,))
            # every node's metrics, back on this device: the mean is then
            # computed as the emulated run computes it
            metrics = mean_metrics([
                {k: v.to(self.device) for k, v in m.items()}
                for m in self.mesh.gather_objects(
                    {k: v.cpu() for k, v in per_node[0].items()})], self.K)
            g_global, comp_state, stats = self.compressor.dist_step(
                comp_state, g_nodes[0], step, phase, self.mesh)
        del g_nodes
        grads = tree_unflatten_vector(g_global, params)
        del g_global
        params, opt_state = self.optimizer.update(grads, opt_state, params,
                                                  step)
        metrics.update(stats)
        return params, opt_state, comp_state, metrics


def node_grads(loss_fn: Callable, params, batch: Dict[str, torch.Tensor],
               K: int, n: int):
    """(K, n) f32 per-node gradients of ``loss_fn(params, shard) -> (loss,
    metrics)`` and the node-mean metrics.  Every entry of the batch
    splits by its rows into K equal node shards, in order (node k takes
    rows [k·B/K, (k+1)·B/K)), as the reference's per-node slices do."""
    out, per_node = grads_of_nodes(loss_fn, params, batch, K, n, range(K))
    return out, mean_metrics(per_node, K)


def grads_of_nodes(loss_fn: Callable, params,
                   batch: Dict[str, torch.Tensor], K: int, n: int,
                   nodes: Sequence[int]):
    """(len(nodes), n) f32 gradients of the given nodes' batch shards (of
    K), and each one's metrics."""
    rows = {x.shape[0] for x in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"batch entries differ in rows: {rows}")
    B = rows.pop()
    if B % K:
        raise ValueError(f"batch {B} is not divisible by {K} nodes")
    out = torch.empty((len(nodes), n), dtype=torch.float32,
                      device=tree_leaves(params)[0].device)
    per_node: List[Dict[str, Any]] = []
    for j, k in enumerate(nodes):
        shard = {key: x[k * B // K:(k + 1) * B // K]
                 for key, x in batch.items()}
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, m = loss_fn(tree_unflatten(params, leaves), shard)
            grads = torch.autograd.grad(loss, leaves)
        off = 0
        for gl in grads:
            out[j, off:off + gl.numel()].copy_(gl.reshape(-1))
            off += gl.numel()
        del grads
        per_node.append({key: val.detach() for key, val in m.items()})
    return out, per_node


def mean_metrics(per_node: Sequence[Dict[str, Any]], K: int
                 ) -> Dict[str, Any]:
    """The node mean of K nodes' metrics, in node order: 0 + m_0/K +
    m_1/K + ..., the order every run of the port logs."""
    metrics: Dict[str, Any] = {}
    for m in per_node:
        for key, val in m.items():
            metrics[key] = metrics.get(key, 0.0) + val / K
    return metrics


@torch.no_grad()
def sim_sgd_step(loss_fn: Callable, compressor: GradientCompressor, params,
                 states, batch: Dict[str, torch.Tensor], step: int,
                 lr: float):
    """One step of the reference's single-host loop: per-node loss and
    gradients, the flat (K, n) buffer, ``compressor.sim_step`` at
    ``phase_for_step(step)``, then plain ``p - lr·g``.  Returns (params,
    states, g, metrics): the global gradient g (n,) and the node-mean
    metrics of ``loss_fn`` with the compressor's stats (``wire`` among
    them) and ``phase``."""
    phase = phase_for_step(step, compressor.cc)
    g_nodes, metrics = node_grads(loss_fn, params, batch, compressor.K,
                                  compressor.layout.n_total)
    g, states, stats = compressor.sim_step(states, g_nodes, step, phase)
    del g_nodes
    params = tree_map(lambda p, gl: p - lr * gl, params,
                      tree_unflatten_vector(g, params))
    return params, states, g, {**metrics, **stats, "phase": phase}


def make_lgc_train_step(model: Model, tc: TrainConfig, K: int,
                        device: torch.device, Ks: Tuple[int, ...] = (),
                        mesh: Optional[ProcessMesh] = None
                        ) -> LGCTrainStep:
    """``Ks``: the K nodes' dp mesh shape, (K_pod, K_data) for a pod
    axis; node ia·K_data + i1 takes batch shard ia·K_data + i1, the
    reference's order over ("pod", "data").  ``mesh``: one node per
    process over that mesh (``launch.mesh.init_process_mesh``)."""
    if mesh is not None and (mesh.K, mesh.Ks) != (K, tuple(Ks or (K,))):
        raise ValueError(f"process mesh {mesh.Ks} is not the dp mesh "
                         f"{tuple(Ks or (K,))}")
    template = model.init(torch.Generator(), "meta")
    return LGCTrainStep(model,
                        build_compressor(tc.compression, template, K, Ks),
                        build_optimizer(tc), device, mesh)
