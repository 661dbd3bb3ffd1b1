"""Optimizers and LR schedules (counterpart of ``repro.optim.optimizers``).

Functional, over nested dicts of tensors: ``init(params) -> state``,
``update(grads, state, params, step) -> (new params, new state)``.
Moments are f32; params keep their dtype.  Updates are written without
fused multiply-adds so each operation rounds as the reference's does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.dist.sharding import dims_over
from repro_torch.utils.tree import keystr_path, tree_leaves_with_path, \
    tree_map

Schedule = Callable[[int], float]
# a gradient tree -> the f32 square of its global norm (``sum_of_squares``)
SumOfSquares = Callable[[Any], torch.Tensor]


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup: int = 0) -> Schedule:
    def fn(step):
        step = float(step)
        if step < warmup:
            return base_lr * min(step / max(warmup, 1), 1.0)
        t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0),
                1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))
    return fn


def step_schedule(base_lr: float, decay_every: int,
                  factor: float = 0.1) -> Schedule:
    """Decay by ``factor`` every ``decay_every`` steps."""
    def fn(step):
        return base_lr * factor ** math.floor(step / decay_every)
    return fn


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]


def sum_of_squares(specs: Optional[Dict[str, tuple]] = None,
                   groups: Optional[Dict[str, Any]] = None) -> SumOfSquares:
    """The square of the global norm that the reference's ``_maybe_clip``
    takes of the logical gradient tree (its optimizer runs on the global
    tree), as a function of this process's blocks of it: each leaf's f32
    sum of squares, summed over the groups of ``groups`` ({axis: group})
    that its spec in ``specs`` ({path: spec}) splits it over; a leaf they
    replicate counts once.  A leaf's blocks are alike over every other
    axis (after the step's sum over ``pod``, say), which is not summed
    over.  With no groups (one process): the whole tree's."""
    groups = groups or {}

    def squares(grads):
        parts: Dict[tuple, torch.Tensor] = {}
        for path, g in tree_leaves_with_path(grads):
            key = tuple(a for a in groups
                        if dims_over(specs[keystr_path(path)], a))
            parts[key] = parts.get(key, 0.0) + torch.sum(g.float() ** 2)
        total = 0.0
        for key, part in parts.items():
            for a in key:
                part = groups[a].all_reduce(part)
            total = total + part
        return total
    return squares


def _maybe_clip(grads, clip_norm: float,
                squares: Optional[SumOfSquares] = None):
    if not clip_norm:
        return grads
    g = torch.sqrt((squares or sum_of_squares())(grads))
    scale = torch.clamp(clip_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale, grads)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _pick(tree, i):
    """Field ``i`` of every tuple leaf of a dict tree of update tuples."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def sgd_momentum(lr: Schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 clip_norm: float = 0.0,
                 squares: Optional[SumOfSquares] = None) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params)}

    def update(grads, state, params, step):
        grads = _maybe_clip(grads, clip_norm, squares)
        rate = lr(step)

        def upd(g, m, p):
            g32 = g.float()
            if weight_decay:
                g32 = g32 + weight_decay * p.float()
            m_new = momentum * m + g32
            d = g32 + momentum * m_new if nesterov else m_new
            return (m_new, (p.float() - rate * d).to(p.dtype))

        out = tree_map(upd, grads, state["m"], params)
        return _pick(out, 1), {"m": _pick(out, 0)}

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: float = 0.0,
          squares: Optional[SumOfSquares] = None) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update(grads, state, params, step):
        grads = _maybe_clip(grads, clip_norm, squares)
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        rate = lr(step)

        def upd(g, m, v, p):
            g32 = g.float()
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * g32 * g32
            d = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if weight_decay:
                d = d + weight_decay * p.float()
            return (m_new, v_new, (p.float() - rate * d).to(p.dtype))

        out = tree_map(upd, grads, state["m"], state["v"], params)
        return _pick(out, 2), {"m": _pick(out, 0), "v": _pick(out, 1)}

    return Optimizer(init, update)


def build_optimizer(tc: TrainConfig, total_steps: int = 0,
                    squares: Optional[SumOfSquares] = None) -> Optimizer:
    """``squares``: how ``tc.grad_clip_norm`` measures the norm
    (``sum_of_squares``; the whole tree's when None)."""
    steps = total_steps or tc.steps
    lr = cosine_schedule(tc.learning_rate, steps, warmup=min(100, steps // 10))
    if tc.optimizer == "sgd_momentum":
        return sgd_momentum(lr, tc.momentum, tc.weight_decay,
                            clip_norm=tc.grad_clip_norm, squares=squares)
    if tc.optimizer == "adamw":
        return adamw(lr, tc.adam_b1, tc.adam_b2,
                     weight_decay=tc.weight_decay,
                     clip_norm=tc.grad_clip_norm, squares=squares)
    raise ValueError(tc.optimizer)
