"""The chaos wire: seeded fault injection over any transport, and the
guard's channels (counterpart of ``repro.dist.chaos``).

  :class:`FaultSpec`       what goes wrong, seeded: bit flips, NaN and +inf
                           overwrites of an op's result, a dropped or stale
                           node contribution, optionally only on some
                           exchange-plan op labels.
  :class:`ChaosTransport`  wraps any transport (``make_transport`` kind
                           ``chaos:<base>``), emulated or across
                           processes: contribution faults act on the
                           faulted node's row of the held nodes' stack
                           before the collective (under a process group
                           only its own process changes anything),
                           payload faults on the result after it, at
                           positions drawn from ``(seed, crc32(op label),
                           salt)`` by numpy, the reference's own draws, so
                           every wire of either package and either layout
                           takes the same faults.
  fault tally              every injection records (op label, kind,
                           count); ``reset_fault_tally`` before a step,
                           ``fault_report`` after.  Every process records
                           every injection, a contribution fault on a node
                           it does not hold too, as the reference records
                           each once at trace time: each process's tally
                           is the emulated step's.
  structural sink          the list the executor opens around each guarded
                           op, into which validators (the packed payload
                           checks, the quantizer's non-finite count) report
                           bad counts.  A report carries the node(s) it
                           belongs to (:func:`on_node`), or every node: the
                           emulated nodes share one process, so the counts
                           the reference keeps on each device are kept
                           here per node.
  :func:`raise_on_faults`  ``guard="fail_fast"``'s check on a step's stats:
                           :class:`WireFaultError` naming each faulting op.

This module imports no other module of the port, so ``quantize`` and
``transport`` may import it.
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# "off" (no validation), "scrub" (zero non-finite or out-of-bound result
# elements and invalid packed contributions), "skip_round" (scrub, and a
# round that saw a fault contributes no gradient), "fail_fast" (scrub; the
# driver raises WireFaultError on the step's counts)
GUARD_POLICIES = ("off", "scrub", "skip_round", "fail_fast")

# |x| above this counts as corrupt although finite: a flipped exponent bit
# usually lands near 1e38
GUARD_MAX = 1e30


@dataclass(frozen=True)
class FaultSpec:
    """Seeded faults, per targeted op per step."""
    seed: int = 0
    bitflips: int = 0        # XORed bits in the op result
    nans: int = 0            # result elements overwritten with NaN
    infs: int = 0            # result elements overwritten with +inf
    drop_node: int = -1      # this node's contribution becomes zeros
    stale_node: int = -1     # this node's contribution is rolled by one
    ops: Tuple[str, ...] = ()  # plan-op labels to target; () = all

    @property
    def active(self) -> bool:
        return bool(self.bitflips or self.nans or self.infs
                    or self.drop_node >= 0 or self.stale_node >= 0)


def spec_from_config(cc) -> Optional[FaultSpec]:
    """The config's ``fault_*`` fields as a FaultSpec, or None when no
    fault is configured."""
    spec = FaultSpec(
        seed=cc.fault_seed, bitflips=cc.fault_bitflips,
        nans=cc.fault_nans, infs=cc.fault_infs,
        drop_node=cc.fault_drop_node, stale_node=cc.fault_stale_node,
        ops=tuple(s for s in cc.fault_ops.split(",") if s))
    return spec if spec.active else None


# -- the fault tally ----------------------------------------------------------

_tally = threading.local()


def _tally_ops() -> Dict[str, Dict[str, int]]:
    if not hasattr(_tally, "ops"):
        _tally.ops = {}
    return _tally.ops


def record_fault(label: str, kind: str, count: int) -> None:
    if not count:
        return
    per_op = _tally_ops().setdefault(label, {})
    per_op[kind] = per_op.get(kind, 0) + int(count)


def reset_fault_tally() -> None:
    _tally_ops().clear()


def fault_report() -> Dict[str, Dict[str, int]]:
    """{op label: {fault kind: injected count}} since the last reset."""
    return {label: dict(kinds) for label, kinds in _tally_ops().items()}


# -- the structural sink ------------------------------------------------------

_sink = threading.local()


def structural_sink_active() -> bool:
    return getattr(_sink, "out", None) is not None


@contextlib.contextmanager
def structural_sink(out: List):
    """Scope in which :func:`report_structural` appends (nodes, count)
    pairs to ``out``; the executor opens one per guarded op."""
    prev = getattr(_sink, "out", None), getattr(_sink, "nodes", None)
    _sink.out, _sink.nodes = out, None
    try:
        yield out
    finally:
        _sink.out, _sink.nodes = prev


@contextlib.contextmanager
def on_node(nodes: Union[None, int, Sequence[int]]):
    """Reports inside belong to node ``nodes`` (an index or several; None:
    every node): the work inside is what that node computes on its own."""
    prev = getattr(_sink, "nodes", None)
    _sink.nodes = None if nodes is None else \
        (int(nodes),) if np.ndim(nodes) == 0 else tuple(int(i) for i in nodes)
    try:
        yield
    finally:
        _sink.nodes = prev


def report_structural(count: torch.Tensor) -> None:
    """Add a bad count to the open sink, for the current node(s); nothing
    when no guard runs."""
    out = getattr(_sink, "out", None)
    if out is not None:
        out.append((getattr(_sink, "nodes", None), count))


# -- fail_fast's check --------------------------------------------------------


class WireFaultError(RuntimeError):
    """Raised by :func:`raise_on_faults`: names every faulting op label
    and its bad-element count."""


def raise_on_faults(stats: Dict[str, Any], step=None) -> None:
    """Raise :class:`WireFaultError` if any ``fault/<label>`` count of a
    step's stats is nonzero."""
    bad = {}
    for k, v in stats.items():
        if k.startswith("fault/"):
            c = int(torch.as_tensor(v).sum())
            if c:
                bad[k[len("fault/"):]] = c
    if bad:
        at = f" at step {int(step)}" if step is not None else ""
        raise WireFaultError(
            f"fail_fast: faulty exchange op(s){at}: {bad} "
            f"(bad elements per plan-op label)")


# -- the transport wrapper ----------------------------------------------------


class ChaosTransport:
    """``spec``'s faults around a base transport's cross-node operations.
    ``kind`` is the base's, so the plan prices and dispatches as on the
    base; the executor's and the compressor's other needs (K, the held
    nodes, guard, the process mesh, the byte and message tallies, the op
    label scope) are the base's.  Every op's result has the same shape
    on the stacked axis and under a process group, so a payload fault
    lands on the same elements in both."""

    def __init__(self, base, spec: FaultSpec = FaultSpec()):
        self.base, self.spec = base, spec

    @property
    def kind(self) -> str:
        return self.base.kind

    @property
    def K(self) -> int:
        return self.base.K

    @property
    def nodes(self):
        return self.base.nodes

    def node_tally(self):
        return self.base.node_tally()

    @property
    def guard(self) -> str:
        return self.base.guard

    @property
    def group(self):
        return self.base.group

    @property
    def tally(self):
        return self.base.tally

    @property
    def messages(self):
        return self.base.messages

    def wire_op(self, label: str):
        return self.base.wire_op(label)

    def _label(self, fallback: str) -> str:
        return self.base._label or fallback

    def _on(self, label: str) -> bool:
        return not self.spec.ops or label in self.spec.ops

    def _rng(self, label: str, salt: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.spec.seed, zlib.crc32(label.encode()), salt))

    @staticmethod
    def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
        """Host draws onto ``dev`` without waiting for it: a blocking copy
        to the card synchronizes its stream, a pinned one does not."""
        t = torch.from_numpy(a)
        if dev.type != "cuda":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def _corrupt(self, res: torch.Tensor, label: str) -> torch.Tensor:
        """Bit flips (floats on their f32 bits, indices on their int32
        bits, as the reference holds them), then NaN and +inf overwrites,
        on the flattened result; each recorded in the tally."""
        s = self.spec
        if not self._on(label) or not (s.bitflips or s.nans or s.infs):
            return res
        size = res.numel() if res.dim() else 0
        if size == 0:
            return res
        flat = res.reshape(-1).clone()
        floating = res.is_floating_point()
        dev = res.device
        if s.bitflips and (floating or res.dtype in (torch.int32,
                                                     torch.int64)):
            m = min(s.bitflips, size)
            rng = self._rng(label, 1)
            pos = self._to(rng.choice(size, size=m, replace=False), dev)
            masks = self._to((np.uint32(1) << rng.integers(
                0, 32, size=m, dtype=np.uint32)).view(np.int32), dev)
            if floating:
                w = flat.to(torch.float32).view(torch.int32)
                w[pos] = w[pos] ^ masks
                flat = w.view(torch.float32).to(res.dtype)
            else:
                w = flat.to(torch.int32)
                w[pos] = w[pos] ^ masks
                flat = w.to(res.dtype)
            record_fault(label, "bitflip", m)
        for kind, count, salt, value in (("nan", s.nans, 2, float("nan")),
                                         ("inf", s.infs, 3, float("inf"))):
            if count and floating:
                m = min(count, size)
                pos = self._to(self._rng(label, salt).choice(
                    size, size=m, replace=False), dev)
                flat.index_fill_(0, pos, value)    # a scalar, not a copy
                record_fault(label, kind, m)
        return flat.view(res.shape)

    def _contrib(self, x: torch.Tensor, label: str) -> torch.Tensor:
        """``drop_node``'s row of the held nodes' contributions becomes
        zeros, ``stale_node``'s is rolled by one along its last axis
        (finite and wrong: no guard can see it); where the node is not
        held here (another process's), nothing changes but the tally, as
        the reference's ``where(_index() == node)``."""
        s = self.spec
        if not self._on(label) or (s.drop_node < 0 and s.stale_node < 0):
            return x
        x = x.clone()
        nodes = self.nodes
        if 0 <= s.drop_node < self.K:
            if s.drop_node in nodes:
                x[nodes.index(s.drop_node)] = 0
            record_fault(label, "drop", 1)
        if 0 <= s.stale_node < self.K:
            if s.stale_node in nodes:
                row = nodes.index(s.stale_node)
                x[row] = torch.roll(x[row], 1, -1)
            record_fault(label, "stale", 1)
        return x

    # -- the cross-node operations --------------------------------------------

    def mean(self, x):
        label = self._label("mean")
        return self._corrupt(self.base.mean(self._contrib(x, label)), label)

    def sum(self, x):
        label = self._label("sum")
        return self._corrupt(self.base.sum(self._contrib(x, label)), label)

    def all_gather(self, x):
        label = self._label("all_gather")
        return self._corrupt(self.base.all_gather(self._contrib(x, label)),
                             label)

    def from_leader(self, x, leader: int):
        label = self._label("from_leader")
        return self._corrupt(self.base.from_leader(x, leader), label)

    def broadcast_packed(self, idx, leader: int, n: int, plan=None):
        label = self._label("broadcast_packed")
        return self._corrupt(
            self.base.broadcast_packed(idx, leader, n, plan=plan), label)

    def mean_q8(self, x):
        label = self._label("mean_q8")
        return self._corrupt(self.base.mean_q8(self._contrib(x, label)),
                             label)

    def sparse_mean(self, vals, idx, n: int):
        label = self._label("sparse_mean")
        return self._corrupt(
            self.base.sparse_mean(self._contrib(vals, label), idx, n), label)

    def sparse_gather_packed(self, vals, idx, n: int, plan=None):
        label = self._label("sparse_gather_packed")
        return self._corrupt(self.base.sparse_gather_packed(
            self._contrib(vals, label), idx, n, plan=plan), label)

    def sparse_mean_packed(self, vals, idx, n: int, plan=None):
        label = self._label("sparse_mean_packed")
        return self._corrupt(self.base.sparse_mean_packed(
            self._contrib(vals, label), idx, n, plan=plan), label)
