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
wraps any of them as ``chaos:<base>`` (``chaos.ChaosTransport``).

Given a process mesh (``group``, a ``dist.p2p.ProcessMesh``) each class is
the same wire with one node per process, the reference's one class per
wire on whatever mesh it is handed: a per-node value carries a leading
axis of the nodes held here (one), a global value none, and the results
are bitwise the emulated ones (``mesh`` at K = 2; at larger K its
``all_reduce`` orders its additions as the library likes).  ``mesh``
reduces, gathers and broadcasts with the library's collectives
(``all_reduce``, ``all_gather``, ``broadcast``) and tallies the bytes the
reference's lowering accounts for; the ring family runs every exchange,
its gathers too, as point-to-point hops (``dist.p2p``) and tallies the
bytes each process hands to its sends.  :meth:`SimTransport.node_tally`
is then the nodes' mean of those tallies, the emulated per-node rows.
``ring_hier`` caps each level's messages at ``intra_chunk`` /
``inter_chunk`` elements (``CompressionConfig.ring_intra_chunk`` /
``ring_inter_chunk``; 0 = one message a hop); on the stacked axis a cap
changes neither values nor bytes, and the emulated wires ignore them.
The chaos wire and the guards do not run under a process group yet
(ROADMAP.md Queue 1 item 7b).
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
from repro_torch.dist import p2p as P
from repro_torch.dist import packed as PK
from repro_torch.dist import quantize as Q
from repro_torch.kernels.bitpack import f32_reciprocal

# what a process-group error names: the item that ports it next
PG_DEFERRED = "ROADMAP.md Queue 1 item 7b"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _scatter_rows(rows, n: int, dtype, device) -> torch.Tensor:
    """(K, n): row i holds the pairs (vals, idx) of ``rows[i]`` scattered
    densely; indices >= n (the sentinel) are dropped."""
    out = torch.zeros((len(rows), n + 1), dtype=dtype, device=device)
    for i, (vals, idx) in enumerate(rows):
        out[i].scatter_add_(0, idx.long().clamp(0, n), vals.to(dtype))
    return out[:, :n]


def _scatter_mean(rows, n: int, dtype, device) -> torch.Tensor:
    """(n,): :func:`collectives.node_mean` of :func:`_scatter_rows`,
    bitwise, in one buffer: each node's pairs are added to the running sum
    in node order.  No scattered row holds -0 (each value lands on +0), so
    no partial sum is -0, and skipping a node's untouched zeros changes
    nothing; at llama3.2-1b width the K dense rows were gigabytes each."""
    out = torch.zeros(n + 1, dtype=dtype, device=device)
    for vals, idx in rows:
        out.scatter_add_(0, idx.long().clamp(0, n), vals.to(dtype))
    return out[:n].mul_(f32_reciprocal(len(rows), device))


@dataclass
class SimTransport:
    K: int
    scale_block: int = Q.SCALE_BLOCK       # values per int8-wire scale
    Ks: Tuple[int, ...] = ()               # dp mesh shape; () = (K,)
    wire_buckets: int = 1                  # buckets per ring exchange
    guard: str = "off"                     # the executor's guard policy
    group: Optional[P.ProcessMesh] = None  # one node per process
    intra_chunk: int = 0                   # ring_hier's message caps, in
    inter_chunk: int = 0                   # elements (process group only)
    # {op label: {collective kind: bytes per node}} recorded since creation
    # (under a process group: the bytes this process sent)
    tally: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # {op label: messages this process sent} (process group only)
    messages: Dict[str, int] = field(default_factory=dict)
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
        if self.group is not None:
            if self.group.Ks != self.Ks:
                raise ValueError(f"process mesh {self.group.Ks} is not the "
                                 f"dp mesh {self.Ks}")
            if self.guard != "off":
                raise NotImplementedError(
                    f"guard {self.guard!r} under a process group is "
                    f"{PG_DEFERRED}")

    @property
    def nodes(self) -> Tuple[int, ...]:
        """The global indices of the nodes held here, the per-node
        values' leading axis: all K emulated, this process's one under a
        process group."""
        if self.group is not None:
            return (self.group.node,)
        return tuple(range(self.K))

    def node_tally(self) -> Dict[str, Dict[str, float]]:
        """The per-node rows {op label: {kind: bytes}}: the tally, or
        under a process group the nodes' mean of what each sent (a
        collective: every process calls it)."""
        if self.group is None:
            return self.tally
        return self.group.node_mean_rows(self.tally)

    def _record(self, kind: str, nbytes: float,
                bucket: Optional[int] = None) -> None:
        """Add ``nbytes`` under ``kind`` to the current op's row, or to
        row ``<op>#b<bucket>`` for bucket ``bucket``."""
        if nbytes and self._label is not None:
            label = self._label if bucket is None \
                else f"{self._label}#b{bucket}"
            row = self.tally.setdefault(label, {})
            row[kind] = row.get(kind, 0.0) + float(nbytes)

    def _sent(self, kind: str, nbytes: float,
              bucket: Optional[int] = None) -> None:
        """One message handed to a send (``dist.p2p``'s record)."""
        self._record(kind, nbytes, bucket)
        if self._label is not None:
            label = self._label if bucket is None \
                else f"{self._label}#b{bucket}"
            self.messages[label] = self.messages.get(label, 0) + 1

    def mean(self, x):
        self._record("all_reduce", 2 * (self.K - 1) / self.K * _nbytes(x[0]))
        if self.group is not None:
            return C._mean_of(self.group.all_reduce_sum(x[0]), "mean",
                              self.K)
        return C.node_mean(x)

    def mean_q8(self, x):
        """The fake int8 mean: each node's values through the int8 round
        trip, then the node mean, on the f32 all_reduce wire.  Under a
        process group each node's round-tripped values are summed by the
        all_reduce, as on the reference's mesh, where no node's dequantize
        fuses into another's add."""
        if self.group is not None:
            return self.mean(_fake_quantize_nodes(x, self.scale_block,
                                                  self.nodes))
        self._record("all_reduce", 2 * (self.K - 1) / self.K * _nbytes(x[0]))
        return C.node_mean_q8(x, self.scale_block)

    def all_gather(self, x):
        self._record("all_gather", (self.K - 1) * _nbytes(x[0]))
        if self.group is not None:
            return self.group.all_gather(x[0])
        return x

    def from_leader(self, x, leader: int):
        self._record("broadcast", (self.K - 1) / self.K * _nbytes(x[0]))
        if self.group is not None:
            return self.group.broadcast(x[0], leader)
        return x[leader]

    def broadcast_packed(self, idx, leader: int, n: int, plan=None):
        """The leader's (sorted) index set, as the raw int32 broadcast;
        ``plan`` shapes only the packed ring's payload."""
        return self.from_leader(idx, leader)

    def _pairs(self, vals, idx):
        """Every node's (vals, idx) pairs, in node order; the wire moves
        them as two all_gathers."""
        if self.group is not None:
            vals, idx = self.all_gather(vals), self.all_gather(idx)
        else:
            self._record("all_gather", (self.K - 1) * (_nbytes(vals[0])
                                                       + _nbytes(idx[0])))
        return list(zip(vals, idx))

    def _sparse_gather(self, vals, idx, n: int):
        """(K, n): each node's sparse (vals, idx) pairs scattered densely
        (indices >= n dropped)."""
        if vals.shape[-1] == 0:
            return torch.zeros((self.K, n), dtype=vals.dtype,
                               device=vals.device)
        return _scatter_rows(self._pairs(vals, idx), n, vals.dtype,
                             vals.device)

    def sparse_mean(self, vals, idx, n: int):
        """Mean over nodes of per-node sparse (vals, idx) pairs as a dense
        (n,) vector, on the exact f32 + int32 wire."""
        if vals.shape[-1] == 0:
            return torch.zeros((n,), dtype=vals.dtype, device=vals.device)
        return _scatter_mean(self._pairs(vals, idx), n, vals.dtype,
                             vals.device)

    def sparse_gather_packed(self, vals, idx, n: int, plan=None):
        """The exact oracle of the packed wire: the per-node scatters of
        the untouched pairs, (K, n), tallied like :meth:`sparse_mean`."""
        return self._sparse_gather(vals, idx, n)

    def sparse_mean_packed(self, vals, idx, n: int, plan=None):
        return self.sparse_mean(vals, idx, n)


def _fake_quantize_nodes(x, scale_block: int, nodes) -> torch.Tensor:
    """Each node's values through its own int8 round trip (row j is
    node ``nodes[j]``'s)."""
    out = []
    for k, node in enumerate(nodes):
        with CH.on_node(node):
            out.append(Q.fake_quantize(x[k], scale_block))
    return torch.stack(out)


class RingTransport(SimTransport):
    """Every cross-node reduction through the chunked ring (one ring per
    dp axis) and the leader exchange through the forwarding broadcast;
    all_gathers and the exact sparse exchanges as on
    :class:`SimTransport`."""

    kind = "ring"

    def mean(self, x):
        if self.group is not None:
            return P.ring_allreduce(x[0], self.group, self._sent, op="mean",
                                    n_buckets=self.wire_buckets)
        return C.ring_allreduce(x, self._record, op="mean", Ks=self.Ks,
                                n_buckets=self.wire_buckets)

    def sum(self, x):
        if self.group is not None:
            return P.ring_allreduce(x[0], self.group, self._sent, op="add",
                                    n_buckets=self.wire_buckets)
        return C.ring_allreduce(x, self._record, op="add", Ks=self.Ks,
                                n_buckets=self.wire_buckets)

    def all_gather(self, x):
        """Under a process group, one ring circulation per axis (the bytes
        of the reference's accounted all_gather, here measured)."""
        if self.group is not None:
            return P.all_gather(x[0], self.group, self._sent)
        return super().all_gather(x)

    def from_leader(self, x, leader: int):
        if self.group is not None:
            return P.ring_broadcast(x[0], leader, self.group, self._sent)
        return C.ring_broadcast(x, leader, self._record)

    def mean_q8(self, x):
        """Each node's values through the int8 round trip, then the f32
        ring mean (f32 bytes on the wire)."""
        return self.mean(_fake_quantize_nodes(x, self.scale_block,
                                              self.nodes))


class RingQ8Transport(RingTransport):
    """The ring whose ``mean_q8`` rides the real int8 wire
    (:func:`collectives.ring_allreduce_q8`); every other exchange is
    :class:`RingTransport`'s f32 traffic."""

    kind = "ring_q8"

    def mean_q8(self, x):
        if self.group is not None:
            return P.ring_allreduce_q8(x[0], self.group, self._sent,
                                       op="mean",
                                       scale_block=self.scale_block,
                                       n_buckets=self.wire_buckets)
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
        if self.group is not None:
            return P.hierarchical_ring_allreduce(
                x[0], self.group, self._sent, op,
                n_buckets=self.wire_buckets, intra_cap=self.intra_chunk,
                inter_cap=self.inter_chunk)
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
        """Each held node's payload; under a guard each node's quantizer
        count is its own."""
        out = []
        for node, (vals, idx) in zip(self.nodes, pairs):
            with CH.on_node(node):
                out.append(PK.encode_sparse_fused(vals, idx, plan))
        return out

    def _gather(self, payloads, bucket=None):
        """The gathered (K, ...) table of the held nodes' payloads."""
        if self.group is not None:
            return P.all_gather_packed(payloads[0], self.group, self._sent,
                                       bucket)
        return C.all_gather_packed(payloads, self._record, bucket)

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
        if vals.shape[-1] == 0:
            return super().sparse_gather_packed(vals, idx, n)
        return _scatter_rows(self._packed_rows(vals, idx, n, plan), n,
                             vals.dtype, vals.device)

    def sparse_mean_packed(self, vals, idx, n: int, plan=None):
        if vals.shape[-1] == 0:
            return super().sparse_mean_packed(vals, idx, n)
        return _scatter_mean(self._packed_rows(vals, idx, n, plan), n,
                             vals.dtype, vals.device)

    def _packed_rows(self, vals, idx, n: int, plan):
        """Every node's pairs as they arrive over the packed wire, in node
        order: (vals, idx) rows decoded from the gathered table."""
        k = vals.shape[-1]
        # the exchange plan's PackPlan, priced for this same (n, k)
        assert plan is not None and (plan.n, plan.k) == (n, k), (plan, n, k)
        B, kb = (1, k) if plan.raw_index else \
            C.bucket_widths(k, self.wire_buckets)
        if B == 1:
            table = self._gather(self._encode(zip(vals, idx), plan))
            return list(zip(*self._decode_table(table, plan)))
        sub = PK.bucket_plan(plan, kb)
        pad = B * kb - k
        pairs = []
        for i in range(vals.shape[0]):
            vs, is_ = PK._sort_pairs(vals[i], idx[i])
            pairs.append((F.pad(vs, (0, pad)),
                          F.pad(is_, (0, pad), value=n)))

        def encode(b):
            return self._encode([(vs[b * kb:(b + 1) * kb],
                                  is_[b * kb:(b + 1) * kb])
                                 for vs, is_ in pairs], sub)
        if self.group is not None:
            # bucket b + 1 is encoded while bucket b circulates
            tables = P.all_gather_packed_buckets(
                lambda b: encode(b)[0], B, self.group, self._sent)
        else:
            tables = [self._gather(encode(b), b) for b in range(B)]
        # the B·K payloads, bucket-major, decoded in one launch
        vals_t, idx_t = self._decode_table(
            tuple(torch.cat(parts) for parts in zip(*tables)), sub)
        vals_t, idx_t = vals_t.view(B, self.K, kb), idx_t.view(B, self.K, kb)
        return [(vals_t[:, i].reshape(-1), idx_t[:, i].reshape(-1))
                for i in range(self.K)]

    def broadcast_packed(self, idx, leader: int, n: int, plan=None):
        k = idx.shape[-1]
        if k == 0:
            return self.from_leader(idx, leader)
        # the exchange plan's PackPlan, priced for this same (n, k)
        assert plan is not None and (plan.n, plan.k) == (n, k), (plan, n, k)
        if self.group is None:
            got = C.ring_broadcast_packed(
                PK.encode_indices(idx[leader], plan), self.K, self._record)
        else:
            # only the leader encodes; the others receive into its shapes
            payload = PK.encode_indices(idx[0], plan) \
                if self.group.node == leader \
                else PK.empty_index_payload(plan, idx.device)
            got = P.ring_broadcast_packed(payload, leader, self.group,
                                          self._sent)
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
                   fault: Optional[CH.FaultSpec] = None,
                   group: Optional[P.ProcessMesh] = None,
                   intra_chunk: int = 0, inter_chunk: int = 0):
    """The transport for ``CompressionConfig.transport``: ``mesh`` is
    :class:`SimTransport`, whose tally the mesh pricer predicts.
    ``scale_block`` (0 = ``quantize.SCALE_BLOCK``) is the int8 wires'
    scale granularity; ``Ks`` the dp mesh's shape (default (K,));
    ``wire_buckets`` the ring exchanges' bucket count; ``guard`` the
    executor's policy, which also arms the packed ring's validation.
    ``chaos:<base>`` wraps the base in a :class:`chaos.ChaosTransport`
    with ``fault`` (default: no fault); an active ``fault`` wraps any
    base.  Emulated on the stacked node axis, or given a process mesh
    ``group`` the same wire with this process's node, ``ring_hier``'s
    messages capped at ``intra_chunk`` / ``inter_chunk`` elements."""
    spec = None
    if kind.startswith("chaos:"):
        kind = kind[len("chaos:"):]
        spec = fault if fault is not None else CH.FaultSpec()
    elif fault is not None and fault.active:
        spec = fault
    if kind not in TRANSPORTS:
        raise ValueError(f"unknown transport {kind!r}; known: "
                         f"{tuple(TRANSPORTS)} (optionally chaos:<base>)")
    if group is not None and spec is not None:
        raise NotImplementedError(
            f"the chaos wire under a process group is {PG_DEFERRED}")
    base = TRANSPORTS[kind](
        K, scale_block or Q.SCALE_BLOCK, tuple(Ks or (K,)),
        max(int(wire_buckets or 1), 1), guard, group=group,
        intra_chunk=int(intra_chunk or 0), inter_chunk=int(inter_chunk or 0))
    return CH.ChaosTransport(base, spec) if spec is not None else base
