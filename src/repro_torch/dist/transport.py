"""Transports: how bytes move between the K LGC nodes (counterpart of
``repro.dist.transport``).

The K data-parallel nodes are emulated on one device as stacked (K, ...)
tensors (the reference's SimTransport, and the paper's
several-nodes-per-GPU setup).  A per-node value carries a leading K axis;
a global value does not.  Cross-node operations reduce over that axis and
record, per exchange-plan op, the bytes each node puts on the wire, so
the trainer's per-op byte rows can be held against
``dist.plan.wire_terms_by_op`` for the same transport:

  SimTransport         the lax collectives of the reference's ``mesh``
                       transport, tallied as that lowering moves them
  RingTransport        the reference's explicit chunked ring
                       (``dist.collectives``): reductions through
                       ``ring_allreduce``, the leader exchange through
                       ``ring_broadcast``
  RingQ8Transport      the ring whose q8 reduction (``lgc_rar_q8``'s
                       encoding) ships int8 values + per-block f32 scales
                       through ``ring_allreduce_q8``
  RingPackedTransport  the ring whose packed sparse exchanges ship the
                       real packed payload (``dist.packed``: bit-packed
                       indices, int8 values, f32 scales) and whose leader
                       index set rides the packed index wire

On the float wires ``mean_q8`` fake-quantizes each node's values (the
quantize -> dequantize round trip of ``dist.quantize``) and reduces them
in f32, moving f32 bytes, as the reference does.

Every mean over nodes is :func:`collectives.node_mean`, the reference's
order of additions under ``jit``.  Real multi-process transports (NCCL)
are ROADMAP.md Queue 1, "multi-process NCCL transports".
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist import packed as PK
from repro_torch.dist import quantize as Q


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _scatter_rows(rows, n: int, dtype, device) -> torch.Tensor:
    """(K, n): row i holds the pairs (vals, idx) of ``rows[i]`` scattered
    densely; indices >= n (the sentinel) are dropped."""
    out = torch.zeros((len(rows), n + 1), dtype=dtype, device=device)
    for i, (vals, idx) in enumerate(rows):
        out[i].scatter_add_(0, idx.long().clamp(0, n), vals.to(dtype))
    return out[:, :n]


@dataclass
class SimTransport:
    K: int
    scale_block: int = Q.SCALE_BLOCK       # values per int8-wire scale
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
        return C.node_mean(x)

    def mean_q8(self, x):
        """The fake int8 mean: each node's values through the int8 round
        trip, then the node mean, on the f32 all_reduce wire."""
        self._record("all_reduce", 2 * (self.K - 1) / self.K * _nbytes(x[0]))
        return C.node_mean_q8(x, self.scale_block)

    def all_gather(self, x):
        self._record("all_gather", (self.K - 1) * _nbytes(x[0]))
        return x

    def from_leader(self, x, leader: int):
        self._record("broadcast", (self.K - 1) / self.K * _nbytes(x[0]))
        return x[leader]

    def broadcast_packed(self, idx, leader: int, n: int, plan=None):
        """The leader's (sorted) index set, as the raw int32 broadcast;
        ``plan`` shapes only the packed ring's payload."""
        return self.from_leader(idx, leader)

    def _sparse_gather(self, vals, idx, n: int):
        """(K, n): each node's sparse (vals, idx) pairs scattered densely
        (indices >= n dropped); the wire moves the pairs (two
        all_gathers)."""
        if vals.shape[-1] == 0:
            return torch.zeros((self.K, n), dtype=vals.dtype,
                               device=vals.device)
        self._record("all_gather",
                     (self.K - 1) * (_nbytes(vals[0]) + _nbytes(idx[0])))
        return _scatter_rows(list(zip(vals, idx)), n, vals.dtype,
                             vals.device)

    def sparse_mean(self, vals, idx, n: int):
        """Mean over nodes of per-node sparse (vals, idx) pairs as a dense
        (n,) vector, on the exact f32 + int32 wire."""
        return C.node_mean(self._sparse_gather(vals, idx, n))

    def sparse_gather_packed(self, vals, idx, n: int, plan=None):
        """The exact oracle of the packed wire: the per-node scatters of
        the untouched pairs, (K, n), tallied like :meth:`sparse_mean`."""
        return self._sparse_gather(vals, idx, n)

    def sparse_mean_packed(self, vals, idx, n: int, plan=None):
        return C.node_mean(self.sparse_gather_packed(vals, idx, n, plan))


class RingTransport(SimTransport):
    """Every cross-node reduction through the chunked ring and the leader
    exchange through the forwarding broadcast; all_gathers and the exact
    sparse exchanges as on :class:`SimTransport`."""

    kind = "ring"

    def mean(self, x):
        return C.ring_allreduce(x, self._record, op="mean")

    def sum(self, x):
        return C.ring_allreduce(x, self._record, op="add")

    def from_leader(self, x, leader: int):
        return C.ring_broadcast(x, leader, self._record)

    def mean_q8(self, x):
        """Each node's values through the int8 round trip, then the f32
        ring mean (f32 bytes on the wire)."""
        return self.mean(torch.stack([Q.fake_quantize(x[k], self.scale_block)
                                      for k in range(self.K)]))


class RingQ8Transport(RingTransport):
    """The ring whose ``mean_q8`` rides the real int8 wire
    (:func:`collectives.ring_allreduce_q8`); every other exchange is
    :class:`RingTransport`'s f32 traffic."""

    kind = "ring_q8"

    def mean_q8(self, x):
        return C.ring_allreduce_q8(x, self._record, op="mean",
                                   scale_block=self.scale_block)


class RingPackedTransport(RingTransport):
    """The ring whose packed sparse exchanges ship the real packed
    payload: indices decode bit-exact, values pay one int8 quantization.
    Per exchange each node's pairs are encoded (one K4 launch per node)
    and the gathered table of all K payloads is decoded in one K5b
    launch: every node ends with the same table and would decode it
    whole, so one decode of it serves all.  The leader's index set is
    encoded once (K5a) and decoded once (K5b) where the reference, being
    SPMD, encodes on every node and adopts the leader's payload: the same
    numbers."""

    kind = "ring_packed"

    def sparse_gather_packed(self, vals, idx, n: int, plan=None):
        k = vals.shape[-1]
        if k == 0:
            return super().sparse_gather_packed(vals, idx, n)
        # the exchange plan's PackPlan, priced for this same (n, k)
        assert plan is not None and (plan.n, plan.k) == (n, k), (plan, n, k)
        table = C.all_gather_packed(
            [PK.encode_sparse_fused(vals[i], idx[i], plan)
             for i in range(self.K)], self._record)
        vals_t, idx_t = PK.decode_sparse(table, plan)
        return _scatter_rows(list(zip(vals_t, idx_t)), n, vals.dtype,
                             vals.device)

    def broadcast_packed(self, idx, leader: int, n: int, plan=None):
        k = idx.shape[-1]
        if k == 0:
            return self.from_leader(idx, leader)
        # the exchange plan's PackPlan, priced for this same (n, k)
        assert plan is not None and (plan.n, plan.k) == (n, k), (plan, n, k)
        got = C.ring_broadcast_packed(PK.encode_indices(idx[leader], plan),
                                      self.K, self._record)
        return PK.decode_indices(got, plan)


TRANSPORTS = {"mesh": SimTransport, "ring": RingTransport,
              "ring_q8": RingQ8Transport, "ring_packed": RingPackedTransport}


def make_transport(kind: str, K: int, scale_block: int = 0):
    """The emulated transport for ``CompressionConfig.transport``:
    ``mesh`` is :class:`SimTransport`, whose tally the mesh pricer
    predicts.  ``scale_block`` (0 = ``quantize.SCALE_BLOCK``) is the int8
    wires' scale granularity."""
    if kind in TRANSPORTS:
        return TRANSPORTS[kind](K, scale_block or Q.SCALE_BLOCK)
    if kind == "ring_hier":
        raise NotImplementedError("transport 'ring_hier' is ROADMAP.md "
                                  "Queue 1, 'multi-process NCCL "
                                  "transports'")
    if kind.startswith("chaos:"):
        raise NotImplementedError(f"transport {kind!r} is ROADMAP.md Queue "
                                  "1, 'chaos, guards and resume'")
    raise ValueError(f"unknown transport {kind!r}")
