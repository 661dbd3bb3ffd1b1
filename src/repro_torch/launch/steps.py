"""The LGC training step on one device (counterpart of
``repro.launch.steps.make_lgc_train_step`` for the simulated transport).

Per step: K per-node gradients (the reference vmaps over the node axis;
here a loop over nodes), flattened into a (K, n) f32 buffer in the
reference's leaf order, ``GradientCompressor.sim_step``, unflatten, the
optimizer.  No gradient all-reduce happens anywhere else: the compressor's
exchange is the whole cross-node traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.compressors import GradientCompressor, build_compressor
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer, build_optimizer
from repro_torch.utils.tree import (tree_leaves, tree_unflatten,
                                    tree_unflatten_vector)


@dataclass
class LGCTrainStep:
    model: Model
    compressor: GradientCompressor
    optimizer: Optimizer
    device: torch.device

    @property
    def K(self) -> int:
        return self.compressor.K

    def init(self, gen: torch.Generator):
        params = self.model.init(gen, self.device)
        opt_state = self.optimizer.init(params)
        comp_state = self.compressor.init_sim_states(gen, self.device)
        return params, opt_state, comp_state

    def node_grads(self, params, batch: Dict[str, torch.Tensor]):
        """(K, n) f32 per-node gradients and the node-mean metrics.  The
        batch's rows split into K equal node shards, in order."""
        K, n = self.K, self.compressor.layout.n_total
        B = batch["tokens"].shape[0]
        if B % K:
            raise ValueError(f"batch {B} is not divisible by {K} nodes")
        out = torch.empty((K, n), dtype=torch.float32, device=self.device)
        metrics: Dict[str, Any] = {}
        for k in range(K):
            shard = {key: x[k * B // K:(k + 1) * B // K]
                     for key, x in batch.items()}
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            with torch.enable_grad():
                loss, m = self.model.loss(tree_unflatten(params, leaves),
                                          shard)
                grads = torch.autograd.grad(loss, leaves)
            off = 0
            for gl in grads:
                out[k, off:off + gl.numel()].copy_(gl.reshape(-1))
                off += gl.numel()
            del grads
            for key, val in m.items():
                metrics[key] = metrics.get(key, 0.0) + val.detach() / K
        return out, metrics

    @torch.no_grad()
    def step(self, params, opt_state, comp_state, batch, step: int,
             phase: str):
        g_nodes, metrics = self.node_grads(params, batch)
        g_global, comp_state, stats = self.compressor.sim_step(
            comp_state, g_nodes, step, phase)
        del g_nodes
        grads = tree_unflatten_vector(g_global, params)
        del g_global
        params, opt_state = self.optimizer.update(grads, opt_state, params,
                                                  step)
        metrics.update(stats)
        return params, opt_state, comp_state, metrics


def make_lgc_train_step(model: Model, tc: TrainConfig, K: int,
                        device: torch.device, Ks: Tuple[int, ...] = ()
                        ) -> LGCTrainStep:
    """``Ks``: the K nodes' dp mesh shape, (K_pod, K_data) for a pod
    axis; node ia·K_data + i1 takes batch shard ia·K_data + i1, the
    reference's order over ("pod", "data")."""
    template = model.init(torch.Generator(), "meta")
    return LGCTrainStep(model,
                        build_compressor(tc.compression, template, K, Ks),
                        build_optimizer(tc), device)
