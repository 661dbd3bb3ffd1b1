"""Transports: how bytes move between the K LGC nodes (counterpart of
``repro.dist.transport``).

Ported so far: :class:`SimTransport`, the K data-parallel nodes emulated
on one device as stacked (K, ...) tensors (the reference's SimTransport
and the paper's several-nodes-per-GPU setup).  A per-node value carries a
leading K axis; a global value does not.  Cross-node operations reduce
over that axis and record, per exchange-plan op, the bytes each node
would put on the wire under the ``mesh`` lowering (lax collectives), so
the trainer's per-op byte rows can be held against
``dist.plan.wire_terms_by_op``.  Real multi-process transports (NCCL) are
ROADMAP.md Queue 1, "multi-process NCCL transports".
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@dataclass
class SimTransport:
    K: int
    # {op label: {collective kind: bytes per node}} recorded since creation
    tally: Dict[str, Dict[str, float]] = field(default_factory=dict)
    _label: Optional[str] = None

    kind = "sim"

    @contextlib.contextmanager
    def wire_op(self, label: str):
        prev, self._label = self._label, label
        try:
            yield
        finally:
            self._label = prev

    def _record(self, kind: str, nbytes: float) -> None:
        if nbytes and self._label is not None:
            row = self.tally.setdefault(self._label, {})
            row[kind] = row.get(kind, 0.0) + float(nbytes)

    def mean(self, x):
        self._record("all_reduce", 2 * (self.K - 1) / self.K * _nbytes(x[0]))
        return x.mean(0)

    def all_gather(self, x):
        self._record("all_gather", (self.K - 1) * _nbytes(x[0]))
        return x

    def broadcast_packed(self, idx, leader: int, n: int):
        """The leader's (sorted) index set, as the raw int32 broadcast."""
        self._record("broadcast", (self.K - 1) / self.K * _nbytes(idx[0]))
        return idx[leader]

    def _sparse_gather(self, vals, idx, n: int):
        """(K, n): each node's sparse (vals, idx) pairs scattered densely
        (indices >= n dropped); the wire moves the pairs (two
        all_gathers)."""
        if vals.shape[-1] == 0:
            return torch.zeros((self.K, n), dtype=vals.dtype,
                               device=vals.device)
        self._record("all_gather",
                     (self.K - 1) * (_nbytes(vals[0]) + _nbytes(idx[0])))
        out = torch.zeros((self.K, n + 1), dtype=vals.dtype,
                          device=vals.device)
        out.scatter_add_(1, idx.long().clamp(0, n), vals)
        return out[:, :n]

    def sparse_mean(self, vals, idx, n: int):
        """Mean over nodes of per-node sparse (vals, idx) pairs as a dense
        (n,) vector, on the exact f32 + int32 wire."""
        return self._sparse_gather(vals, idx, n).mean(0)

    def sparse_gather_packed(self, vals, idx, n: int, plan=None):
        """The exact oracle of the packed wire: the per-node scatters of
        the untouched pairs, (K, n).  ``plan`` (the op's PackPlan) shapes
        only the packed ring's payload; bytes are tallied as the mesh
        lowering moves them, like :meth:`sparse_mean`."""
        return self._sparse_gather(vals, idx, n)

    def sparse_mean_packed(self, vals, idx, n: int, plan=None):
        return self.sparse_gather_packed(vals, idx, n, plan).mean(0)
