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
  RingHierTransport    the ring whose reductions run the reference's
                       hierarchical intra-pod / inter-pod schedule
                       (``hierarchical_ring_allreduce``) on a (K_pod,
                       K_data) node grid
  RingPackedTransport  the ring whose packed sparse exchanges ship the
                       real packed payload (``dist.packed``: bit-packed
                       indices, int8 values, f32 scales) and whose leader
                       index set rides the packed index wire

``Ks`` is the dp mesh's shape, (K,) or (K_pod, K_data) with node ia·K_data
+ i1 (the reference's row-major ("pod", "data") order): the rings reduce
over one axis after the other, the hierarchical ring level by level.
``wire_buckets`` > 1 buckets every ring exchange and the packed gather,
recording one ``<op label>#b<i>`` row per bucket, as the reference's
bucketed schedule does; ``mesh`` ignores both, as the reference's lax
collectives do.

On the float wires ``mean_q8`` fake-quantizes each node's values (the
quantize -> dequantize round trip of ``dist.quantize``) and reduces them
in f32, moving f32 bytes, as the reference does.

Every mean over nodes is :func:`collectives.node_mean`, the reference's
order of additions under ``jit``.

Under a guard policy (``guard``, which the executor reads) the packed
ring validates every received payload (``packed.validate_payload``) and
zeroes one that fails, and each node's quantizer work reports its
non-finite count as that node's (``chaos.on_node``).  ``make_transport``
wraps any of them as ``chaos:<base>`` (``chaos.ChaosTransport``).  Real multi-process transports (NCCL)
are ROADMAP.md Queue 1 item 6, "multi-process transports".
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import chaos as CH
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
    Ks: Tuple[int, ...] = ()               # dp mesh shape; () = (K,)
    wire_buckets: int = 1                  # buckets per ring exchange
    guard: str = "off"                     # the executor's guard policy
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

    def __post_init__(self):
        self.Ks = tuple(self.Ks) or (self.K,)
        if math.prod(self.Ks) != self.K:
            raise ValueError(f"mesh shape {self.Ks} does not hold "
                             f"{self.K} nodes")
        if self.guard not in CH.GUARD_POLICIES:
            raise ValueError(f"unknown guard {self.guard!r}; known: "
                             f"{CH.GUARD_POLICIES}")

    def _record(self, kind: str, nbytes: float,
                bucket: Optional[int] = None) -> None:
        """Add ``nbytes`` under ``kind`` to the current op's row, or to
        row ``<op>#b<bucket>`` for bucket ``bucket``."""
        if nbytes and self._label is not None:
            label = self._label if bucket is None \
                else f"{self._label}#b{bucket}"
            row = self.tally.setdefault(label, {})
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


def _fake_quantize_nodes(x, scale_block: int) -> torch.Tensor:
    """Each node's values through its own int8 round trip."""
    out = []
    for k in range(x.shape[0]):
        with CH.on_node(k):
            out.append(Q.fake_quantize(x[k], scale_block))
    return torch.stack(out)


class RingTransport(SimTransport):
    """Every cross-node reduction through the chunked ring (one ring per
    dp axis) and the leader exchange through the forwarding broadcast;
    all_gathers and the exact sparse exchanges as on
    :class:`SimTransport`."""

    kind = "ring"

    def mean(self, x):
        return C.ring_allreduce(x, self._record, op="mean", Ks=self.Ks,
                                n_buckets=self.wire_buckets)

    def sum(self, x):
        return C.ring_allreduce(x, self._record, op="add", Ks=self.Ks,
                                n_buckets=self.wire_buckets)

    def from_leader(self, x, leader: int):
        return C.ring_broadcast(x, leader, self._record)

    def mean_q8(self, x):
        """Each node's values through the int8 round trip, then the f32
        ring mean (f32 bytes on the wire)."""
        return self.mean(_fake_quantize_nodes(x, self.scale_block))


class RingQ8Transport(RingTransport):
    """The ring whose ``mean_q8`` rides the real int8 wire
    (:func:`collectives.ring_allreduce_q8`); every other exchange is
    :class:`RingTransport`'s f32 traffic."""

    kind = "ring_q8"

    def mean_q8(self, x):
        return C.ring_allreduce_q8(x, self._record, op="mean",
                                   scale_block=self.scale_block, Ks=self.Ks,
                                   n_buckets=self.wire_buckets)


class RingHierTransport(RingTransport):
    """The ring whose ``mean`` and ``sum`` run the hierarchical schedule
    (:func:`collectives.hierarchical_ring_allreduce`): reduce-scatter
    inside each pod (the last dp axis), ring-allreduce the owned shard
    across the pods, all-gather inside each pod, so the inter-pod stage
    moves K_data times fewer bytes than the chained rings of
    :class:`RingTransport`.  On one dp axis it is :class:`RingTransport`'s
    schedule; everything but the reductions is inherited."""

    kind = "ring_hier"

    def _hier(self, x, op: str):
        return C.hierarchical_ring_allreduce(x, self.Ks, self._record, op,
                                             n_buckets=self.wire_buckets)

    def mean(self, x):
        return self._hier(x, "mean")

    def sum(self, x):
        return self._hier(x, "add")


class RingPackedTransport(RingTransport):
    """The ring whose packed sparse exchanges ship the real packed
    payload: indices decode bit-exact, values pay one int8 quantization.
    Per exchange each node's pairs are encoded (one K4 launch per node)
    and the gathered table of all K payloads is decoded in one K5b
    launch: every node ends with the same table and would decode it
    whole, so one decode of it serves all.  The leader's index set is
    encoded once (K5a) and decoded once (K5b) where the reference, being
    SPMD, encodes on every node and adopts the leader's payload: the same
    numbers.

    Bucketed (``wire_buckets`` > 1, a plan that packs its indices), each
    node's pairs are sorted once and padded with sentinels (value 0,
    index n) to B·kb pairs; bucket b, pairs [b·kb, (b+1)·kb), is a
    self-contained payload under ``packed.bucket_plan``, encoded by its
    own K4 launch (B·K an exchange) and gathered on its own, and the B·K
    gathered payloads decode in one K5b launch.  Each node's result is
    the sum of its B per-bucket scatters in bucket order, as the
    reference adds them; as each index lies in one bucket and lands on a
    zero, that sum is bitwise one scatter of all the node's pairs."""

    kind = "ring_packed"

    def _encode(self, pairs, plan):
        """Each node's payload; under a guard each node's quantizer count
        is its own."""
        out = []
        for i, (vals, idx) in enumerate(pairs):
            with CH.on_node(i):
                out.append(PK.encode_sparse_fused(vals, idx, plan))
        return out

    def _decode_table(self, table, plan):
        """The gathered table -> (vals, idx), (B, k) each, in one decode.
        Under a guard each payload is validated on that decode; one that
        fails contributes zeros (its pairs stay in the sender's u, v) and
        its failed checks are reported for every node, since every node
        checks every payload."""
        vals_t, idx_t = PK.decode_sparse(table, plan)
        if self.guard != "off":
            ok, bad = PK.validate_payload(table, plan, idx=idx_t)
            CH.report_structural(bad.sum())
            vals_t = torch.where(ok[:, None], vals_t,
                                 torch.zeros_like(vals_t))
        return vals_t, idx_t

    def sparse_gather_packed(self, vals, idx, n: int, plan=None):
        k = vals.shape[-1]
        if k == 0:
            return super().sparse_gather_packed(vals, idx, n)
        # the exchange plan's PackPlan, priced for this same (n, k)
        assert plan is not None and (plan.n, plan.k) == (n, k), (plan, n, k)
        B, kb = (1, k) if plan.raw_index else \
            C.bucket_widths(k, self.wire_buckets)
        if B == 1:
            table = C.all_gather_packed(
                self._encode(zip(vals, idx), plan), self._record)
            vals_t, idx_t = self._decode_table(table, plan)
            return _scatter_rows(list(zip(vals_t, idx_t)), n, vals.dtype,
                                 vals.device)
        sub = PK.bucket_plan(plan, kb)
        pad = B * kb - k
        pairs = []
        for i in range(self.K):
            vs, is_ = PK._sort_pairs(vals[i], idx[i])
            pairs.append((F.pad(vs, (0, pad)),
                          F.pad(is_, (0, pad), value=n)))
        tables = [C.all_gather_packed(
            self._encode([(vs[b * kb:(b + 1) * kb], is_[b * kb:(b + 1) * kb])
                          for vs, is_ in pairs], sub),
            self._record, bucket=b)
            for b in range(B)]
        # the B·K payloads, bucket-major, decoded in one launch
        vals_t, idx_t = self._decode_table(
            tuple(torch.cat(parts) for parts in zip(*tables)), sub)
        vals_t, idx_t = vals_t.view(B, self.K, kb), idx_t.view(B, self.K, kb)
        return _scatter_rows([(vals_t[:, i].reshape(-1),
                               idx_t[:, i].reshape(-1))
                              for i in range(self.K)], n, vals.dtype,
                             vals.device)

    def broadcast_packed(self, idx, leader: int, n: int, plan=None):
        k = idx.shape[-1]
        if k == 0:
            return self.from_leader(idx, leader)
        # the exchange plan's PackPlan, priced for this same (n, k)
        assert plan is not None and (plan.n, plan.k) == (n, k), (plan, n, k)
        got = C.ring_broadcast_packed(PK.encode_indices(idx[leader], plan),
                                      self.K, self._record)
        out = PK.decode_indices(got, plan)
        if self.guard != "off":
            # the executor repairs the decoded set; here the payload's
            # failed checks are counted
            CH.report_structural(PK.validate_payload(
                got, plan, values=False, idx=out)[1])
        return out


TRANSPORTS = {"mesh": SimTransport, "ring": RingTransport,
              "ring_q8": RingQ8Transport, "ring_hier": RingHierTransport,
              "ring_packed": RingPackedTransport}


def make_transport(kind: str, K: int, scale_block: int = 0, *,
                   Ks: Optional[Tuple[int, ...]] = None,
                   wire_buckets: int = 1, guard: str = "off",
                   fault: Optional[CH.FaultSpec] = None):
    """The emulated transport for ``CompressionConfig.transport``:
    ``mesh`` is :class:`SimTransport`, whose tally the mesh pricer
    predicts.  ``scale_block`` (0 = ``quantize.SCALE_BLOCK``) is the int8
    wires' scale granularity; ``Ks`` the dp mesh's shape (default (K,));
    ``wire_buckets`` the ring exchanges' bucket count; ``guard`` the
    executor's policy, which also arms the packed ring's validation.
    ``chaos:<base>`` wraps the base in a :class:`chaos.ChaosTransport`
    with ``fault`` (default: no fault); an active ``fault`` wraps any
    base."""
    spec = None
    if kind.startswith("chaos:"):
        kind = kind[len("chaos:"):]
        spec = fault if fault is not None else CH.FaultSpec()
    elif fault is not None and fault.active:
        spec = fault
    if kind not in TRANSPORTS:
        raise ValueError(f"unknown transport {kind!r}; known: "
                         f"{tuple(TRANSPORTS)} (optionally chaos:<base>)")
    base = TRANSPORTS[kind](K, scale_block or Q.SCALE_BLOCK,
                            tuple(Ks or (K,)),
                            max(int(wire_buckets or 1), 1), guard)
    return CH.ChaosTransport(base, spec) if spec is not None else base
