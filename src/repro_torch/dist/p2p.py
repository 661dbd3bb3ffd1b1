"""The ring schedules of ``repro.dist.collectives`` across processes: one
LGC node per process, each ``ppermute`` hop a ``torch.distributed``
point-to-point exchange.

:class:`ProcessMesh` is this process's place in the dp mesh: the mesh
shape ``Ks`` ((K,) or (K_pod, K_data), row-major, node ia·K_data + i1 is
the dp group's rank ia·K_data + i1), its node, and per mesh axis the ring
through it with that ring's process group.  Every process of the world
builds the same groups in the same order (``dist.new_group`` is
collective).

The collectives here take this node's value (no leading node axis) and
return the global one, as :mod:`repro_torch.dist.collectives` does on the
stacked axis, with the same chunk-to-node order and so the same order of
additions: the results are bitwise the emulated ones.  They are written
as hop programs, generators that compute, yield a :class:`Hop` (the
messages to send to the ring's next node and to receive from its
previous one) and resume once it has completed.  :meth:`ProcessMesh.drive`
runs one or several programs side by side: each hop is one
``batch_isend_irecv``, posted as soon as its program reaches it and
waited only when that program needs its data, so the programs' hops and
compute overlap.  A bucketed exchange (``n_buckets`` > 1) is the
reference's software pipeline (``_sw_pipeline``): bucket b's all-gather
hops are in flight while bucket b + 1 reduce-scatters (or, for the packed
gather, encodes).

Every message handed to an ``isend`` is recorded, ``record(kind, nbytes,
bucket)``, so a transport's tally holds the bytes this process actually
sent.  ``cap`` (the reference's ``max_chunk_elems``) splits each message
of a hop into ceil(numel / cap) messages, the bytes unchanged.  With the
gloo backend and CUDA tensors every message is staged through pinned host
buffers: gloo's point-to-point moves host memory.  With NCCL the card's
tensors go directly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.dist import chaos as CH
from repro_torch.dist import quantize as Q
from repro_torch.dist.collectives import bucket_widths
from repro_torch.kernels.bitpack import f32_reciprocal

# record(kind, nbytes, bucket): one message handed to an isend
Record = Callable[[str, float, Optional[int]], None]

_TAGS_PER_STREAM = 1 << 16      # message tags of one program in a drive


@dataclass(frozen=True)
class Ring:
    """The ring of one mesh axis through this node: the global ranks at
    its positions, this node's position and the ring's process group."""
    ranks: Tuple[int, ...]
    pos: int
    group: object

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def next(self) -> int:
        return self.ranks[(self.pos + 1) % self.size]

    @property
    def prev(self) -> int:
        return self.ranks[(self.pos - 1) % self.size]


@dataclass
class Hop:
    """One hop of a ring program: ``sends`` go to the ring's next node,
    ``recvs`` (filled in place) come from its previous one, each tensor
    one message of at most ``cap`` elements a piece (0: whole).  Sent
    bytes are recorded under ``kind`` and ``bucket``."""
    ring: Ring
    sends: Sequence[torch.Tensor]
    recvs: Sequence[torch.Tensor]
    kind: str
    bucket: Optional[int] = None
    cap: int = 0


def _empty(x: torch.Tensor) -> torch.Tensor:
    """A contiguous receive buffer shaped like ``x``: a message lands in
    a view of it."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _pieces(t: torch.Tensor, cap: int) -> List[torch.Tensor]:
    flat = t.reshape(-1)
    if not cap or flat.numel() <= cap:
        return [flat] if flat.numel() else []
    return [flat[s:s + cap] for s in range(0, flat.numel(), cap)]


class _Posted:
    """A posted hop: its works, and the staged receives to copy back to
    the card once they have arrived."""

    def __init__(self, works, copies):
        self.works, self.copies = works, copies

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        for dst, host in self.copies:
            dst.copy_(host, non_blocking=True)


class ProcessMesh:
    """One LGC node per process over the dp mesh ``Ks``, on the initialised
    default process group: node r is rank r of the world, which must hold
    exactly the mesh's K processes.  Every process constructs it (building
    the rings' groups is collective).  ``device`` is where this node's
    tensors live: a CUDA device on the gloo backend moves every message
    through pinned host buffers."""

    def __init__(self, Ks: Sequence[int], device):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised process "
                               "group (torch.distributed)")
        self.Ks = tuple(int(k) for k in Ks)
        self.K = math.prod(self.Ks)
        if dist.get_world_size() != self.K:
            raise ValueError(f"mesh {self.Ks} holds {self.K} nodes, not the "
                             f"{dist.get_world_size()} processes")
        self.node = dist.get_rank()
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.stage = self.device.type == "cuda" and self.backend == "gloo"
        self.group = dist.group.WORLD
        self.coords = tuple(int(c) for c in np.unravel_index(self.node,
                                                             self.Ks))
        grid = np.arange(self.K).reshape(self.Ks)
        self.rings: List[Ring] = []
        for a in range(len(self.Ks)):
            # every ring of axis a, the other axes row-major
            for line in np.moveaxis(grid, a, -1).reshape(-1, self.Ks[a]):
                line = tuple(int(r) for r in line)
                group = self.group if len(self.Ks) == 1 \
                    else dist.new_group(list(line))
                if self.node in line:
                    self.rings.append(Ring(line, line.index(self.node),
                                           group))

    # -- messages -------------------------------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def post(self, hop: Hop, stream: int, record: Record) -> _Posted:
        """Post ``hop``'s messages as one ``batch_isend_irecv``; message j
        of a direction carries tag ``stream``·2^16 + j on both ends."""
        ops, copies = [], []
        base = stream * _TAGS_PER_STREAM
        for j, piece in enumerate(p for t in hop.sends
                                  for p in _pieces(t, hop.cap)):
            if self.stage:
                host = self._host(piece)
                host.copy_(piece)
                piece = host
            elif not piece.is_contiguous():
                piece = piece.contiguous()
            ops.append(dist.P2POp(dist.isend, piece, hop.ring.next,
                                  hop.ring.group, base + j))
            record(hop.kind, piece.numel() * piece.element_size(),
                   hop.bucket)
        assert all(t.is_contiguous() for t in hop.recvs), \
            "a receive buffer must be contiguous: it is filled in place"
        for j, piece in enumerate(p for t in hop.recvs
                                  for p in _pieces(t, hop.cap)):
            if self.stage:
                host = self._host(piece)
                copies.append((piece, host))
                piece = host
            ops.append(dist.P2POp(dist.irecv, piece, hop.ring.prev,
                                  hop.ring.group, base + j))
        return _Posted(dist.batch_isend_irecv(ops) if ops else [], copies)

    def drive(self, record: Record, *programs):
        """Run hop programs side by side and return their results: each
        program's hop is posted as soon as it is yielded and waited just
        before that program resumes, the programs taken in turn, so one's
        hops are in flight while another computes.  Every process runs
        the same programs in the same order (SPMD), so the posts match."""
        out: list = [None] * len(programs)
        posted: list = [None] * len(programs)

        def advance(i):
            try:
                hop = programs[i].send(None)
            except StopIteration as stop:
                out[i], posted[i] = stop.value, None
                return
            posted[i] = self.post(hop, i, record)

        for i in range(len(programs)):
            advance(i)
        while any(p is not None for p in posted):
            for i, p in enumerate(posted):
                if p is not None:
                    p.wait()
                    advance(i)
        return out

    # -- the library's collectives (the mesh wire) ----------------------------

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh buffer holding ``x`` where the backend reads it."""
        if self.stage:
            host = self._host(x)
            host.copy_(x)
            return host
        return x.contiguous().clone()

    def _back(self, buf: torch.Tensor) -> torch.Tensor:
        if not self.stage:
            return buf
        return buf.to(self.device, non_blocking=True)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        buf = self._wire(x)
        dist.all_reduce(buf, group=self.group)
        return self._back(buf)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(K, ...) in node order."""
        buf = self._wire(x)
        parts = [_empty(buf) for _ in range(self.K)]
        dist.all_gather(parts, buf, group=self.group)
        return self._back(torch.stack(parts))

    def broadcast(self, x: torch.Tensor, leader: int) -> torch.Tensor:
        """Node ``leader``'s ``x`` on every node (each passes a tensor of
        the same shape and dtype)."""
        buf = self._wire(x)
        dist.broadcast(buf, src=leader, group=self.group)
        return self._back(buf)

    def gather_objects(self, obj) -> list:
        """Every node's picklable ``obj``, in node order."""
        out: list = [None] * self.K
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def node_mean_rows(self, rows):
        """{label: {kind: bytes}}: the mean over the nodes of each node's
        rows, summed in node order then divided by K (each node's own rows
        hold what it handed to its sends; a broadcast's forwarders send
        and its last node does not)."""
        out: dict = {}
        for r in self.gather_objects(rows):
            for label, kinds in r.items():
                row = out.setdefault(label, {})
                for kind, b in kinds.items():
                    row[kind] = row.get(kind, 0.0) + b
        return {label: {kind: b / self.K for kind, b in kinds.items()}
                for label, kinds in out.items()}


# -- hop programs -------------------------------------------------------------


def _chunks(flat: torch.Tensor, K: int) -> torch.Tensor:
    """(m,) -> (K, c): zero-padded to K·c, c = ceil(m/K)."""
    pad = (-flat.shape[0]) % K
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(K, -1)


def _reduce_scatter(chunks: torch.Tensor, ring: Ring, kind: str,
                    bucket=None, cap: int = 0):
    """The ring's K - 1 reduce-scatter hops on this node's (K, w) chunk
    matrix; returns its fully reduced chunk, (pos + 1) mod K: chunk j is
    summed in node order j, j + 1, ..., as on the stacked axis."""
    K, i = ring.size, ring.pos
    send = chunks[i]
    for t in range(K - 1):
        recv = _empty(send)
        yield Hop(ring, [send], [recv], kind, bucket, cap)
        send = recv + chunks[(i - t - 1) % K]
    return send


def _all_gather(send: torch.Tensor, ring: Ring, kind: str, bucket=None,
                cap: int = 0):
    """Circulate the finished chunks (K - 1 hops): -> the (K, w) table,
    row j chunk j, the same on every node."""
    K, i = ring.size, ring.pos
    out = send.new_empty((K,) + tuple(send.shape))
    out[(i + 1) % K] = send
    for t in range(K - 1):
        recv = _empty(send)
        yield Hop(ring, [send], [recv], kind, bucket, cap)
        out[(i - t) % K] = recv
        send = recv
    return out


def _allreduce(flat: torch.Tensor, ring: Ring, kind: str, bucket=None,
               cap: int = 0):
    """The full ring allreduce (sum) of a flat vector, unbucketed."""
    if ring.size == 1:
        return flat
    m = flat.shape[0]
    shard = yield from _reduce_scatter(_chunks(flat, ring.size), ring, kind,
                                       bucket, cap)
    table = yield from _all_gather(shard, ring, kind, bucket, cap)
    return table.reshape(-1)[:m]


def _compute(fn):
    """A program with no hops: ``fn()`` runs when it is first advanced."""
    return fn()
    yield  # noqa: the yield makes this a generator


def _pipeline(pm: ProcessMesh, record: Record, B: int, prep, move) -> list:
    """The reference's ``_sw_pipeline`` over hop programs: staged =
    prep(0); for each b, move(b, staged) and prep(b + 1) run side by side
    (the move's hops in flight while the next bucket is prepared); the
    last move alone.  Returns the B moves' results."""
    staged = pm.drive(record, prep(0))[0]
    outs = []
    for b in range(B - 1):
        res, staged = pm.drive(record, move(b, staged), prep(b + 1))
        outs.append(res)
    outs.append(pm.drive(record, move(B - 1, staged))[0])
    return outs


def _mean_of(res: torch.Tensor, op: str, K: int) -> torch.Tensor:
    if op == "mean" and K > 1:
        res.mul_(f32_reciprocal(K, res.device))
    return res


# -- the collectives ----------------------------------------------------------


def _ring_axis(pm: ProcessMesh, flat: torch.Tensor, ring: Ring,
               record: Record, kind: str, n_buckets: int,
               cap: int) -> torch.Tensor:
    """One ring's allreduce (sum) of ``flat``; bucketed, bucket b is
    columns [b·cb, (b+1)·cb) of the (K, c) chunk matrix, padded with zero
    columns to B·cb, pipelined."""
    K, m = ring.size, flat.shape[0]
    if K == 1:
        return flat.clone()
    chunks = _chunks(flat, K)
    c = chunks.shape[1]
    B, cb = bucket_widths(c, n_buckets)
    if B == 1:
        return pm.drive(record, _allreduce(flat, ring, kind, None, cap))[0]
    chunks = F.pad(chunks, (0, B * cb - c))
    tables = _pipeline(
        pm, record, B,
        lambda b: _reduce_scatter(chunks[:, b * cb:(b + 1) * cb], ring,
                                  kind, b, cap),
        lambda b, s: _all_gather(s, ring, kind, b, cap))
    return torch.cat(tables, 1)[:, :c].reshape(-1)[:m]


def ring_allreduce(x: torch.Tensor, pm: ProcessMesh, record: Record,
                   op: str = "add", n_buckets: int = 1,
                   cap: int = 0) -> torch.Tensor:
    """The chunked ring allreduce of this node's ``x`` -> the global
    result: one full ring per mesh axis, the first axis first (the
    reference's ``ring_allreduce_multi``), recorded as
    ``ring_allreduce``; ``op="mean"`` multiplies by f32(1/K) once at the
    end."""
    assert op in ("add", "mean"), op
    flat = x.reshape(-1)
    for ring in pm.rings:
        flat = _ring_axis(pm, flat, ring, record, "ring_allreduce",
                          n_buckets, cap)
    return _mean_of(flat.reshape(x.shape), op, pm.K)


def hierarchical_ring_allreduce(x: torch.Tensor, pm: ProcessMesh,
                                record: Record, op: str = "add",
                                n_buckets: int = 1, intra_cap: int = 0,
                                inter_cap: int = 0) -> torch.Tensor:
    """The reference's ``hierarchical_ring_allreduce``: reduce-scatter on
    the intra-pod ring (the last axis), ring-allreduce the owned shard over
    each inter-pod axis, all-gather intra-pod; ``ring_hier_intra`` /
    ``ring_hier_inter``, each level's messages capped at ``intra_cap`` /
    ``inter_cap`` elements.  On two axes with ``n_buckets`` > 1, bucket b
    is inter columns [b·cab, (b+1)·cab) gathered out of the intra chunk
    matrix, so each element keeps its chunk row at both levels (the
    values are the unbucketed ones); bucket b + 1's intra reduce-scatter
    runs while bucket b moves through the inter ring and the intra
    all-gather.  On one axis it is :func:`ring_allreduce` with
    ``intra_cap``."""
    assert op in ("add", "mean"), op
    Ks = pm.Ks
    if len(Ks) == 1:
        return ring_allreduce(x, pm, record, op, n_buckets, intra_cap)
    intra, inters = pm.rings[-1], pm.rings[:-1]
    flat = x.reshape(-1)
    n, K1, Ka = flat.shape[0], Ks[-1], Ks[0]
    chunks = _chunks(flat, K1)
    c = chunks.shape[1]
    ca = -(-c // Ka)
    B, cab = bucket_widths(ca, n_buckets if len(Ks) == 2 else 1)
    lv_in, lv_out = "ring_hier_intra", "ring_hier_inter"
    if B == 1:
        def program():
            shard = yield from _reduce_scatter(chunks, intra, lv_in, None,
                                               intra_cap)
            for ring in inters:
                shard = yield from _allreduce(shard, ring, lv_out, None,
                                              inter_cap)
            return (yield from _all_gather(shard, intra, lv_in, None,
                                           intra_cap))
        table = pm.drive(record, program())[0]
        res = table.reshape(-1)[:n]
    else:
        # the (Ka, ca) shard grid + one zero column that the last bucket's
        # pad columns read
        grid = F.pad(chunks, (0, Ka * ca + 1 - c))
        rows = torch.arange(Ka, device=flat.device)[:, None]
        inter = inters[0]

        def prep(b):
            cols = b * cab + torch.arange(cab, device=flat.device)[None, :]
            gid = torch.where(cols < ca, rows * ca + cols, Ka * ca)
            return _reduce_scatter(grid[:, gid.reshape(-1)], intra, lv_in,
                                   b, intra_cap)

        def move(b, piece):
            full = yield from _allreduce(piece, inter, lv_out, b, inter_cap)
            return (yield from _all_gather(full, intra, lv_in, b,
                                           intra_cap))

        tables = torch.stack(_pipeline(pm, record, B, prep, move))
        out = tables.reshape(B, K1, Ka, cab).permute(1, 2, 0, 3)
        out = out.reshape(K1, Ka, B * cab)[:, :, :ca].reshape(K1, Ka * ca)
        res = out[:, :c].reshape(-1)[:n]
    return _mean_of(res.reshape(x.shape), op, pm.K)


def _reduce_scatter_q8(chunks: torch.Tensor, ring: Ring, sb: int,
                       node: int, bucket=None):
    """The int8 ring's reduce-scatter: each hop ships the partial chunk
    quantized (int8 values, f32 scales) and the receiver adds its
    dequantized values to its own chunk, product and sum one FMA; the
    finished chunk is quantized once -> its (q, scales)."""
    K, i, w = ring.size, ring.pos, chunks.shape[1]
    send = chunks[i]
    for t in range(K - 1):
        with CH.on_node(node):
            q, s = Q.quantize_i8(send, sb)
        rq, rs = _empty(q), _empty(s)
        yield Hop(ring, [q, s], [rq, rs], "ring_allreduce_q8", bucket)
        send = Q.dequantize_add_i8(rq, rs, w, chunks[(i - t - 1) % K])
    with CH.on_node(node):
        return Q.quantize_i8(send, sb)


def _all_gather_q8(qs, w: int, ring: Ring, bucket=None):
    """Circulate the finished chunks' int8 payloads unchanged; every node,
    the owner included, decodes each: -> (K, w)."""
    K, i = ring.size, ring.pos
    q, s = qs
    out = torch.empty((K, w), dtype=torch.float32, device=q.device)
    out[(i + 1) % K] = Q.dequantize_i8(q, s, w)
    for t in range(K - 1):
        rq, rs = _empty(q), _empty(s)
        yield Hop(ring, [q, s], [rq, rs], "ring_allreduce_q8", bucket)
        out[(i - t) % K] = Q.dequantize_i8(rq, rs, w)
        q, s = rq, rs
    return out


def ring_allreduce_q8(x: torch.Tensor, pm: ProcessMesh, record: Record,
                      op: str = "add", scale_block: int = Q.SCALE_BLOCK,
                      n_buckets: int = 1) -> torch.Tensor:
    """The int8 ring allreduce of this node's ``x``, one ring per mesh
    axis in turn (``ring_allreduce_q8_multi``), recorded as
    ``ring_allreduce_q8``; ``op="mean"`` multiplies by f32(1/K) after the
    sums.  On a ring of one node nothing moves and the value makes one
    quantize -> dequantize round trip.  Bucketed, each bucket's columns
    are their own scale blocks (zero pad columns to B·cb), pipelined."""
    assert op in ("add", "mean"), op
    flat = x.to(torch.float32).reshape(-1)
    for ring in pm.rings:
        K, m = ring.size, flat.shape[0]
        if K == 1:
            with CH.on_node(pm.node):
                flat = Q.fake_quantize(flat, scale_block)
            continue
        chunks = _chunks(flat, K)
        c = chunks.shape[1]
        B, cb = bucket_widths(c, n_buckets)
        if B == 1:
            def program():
                qs = yield from _reduce_scatter_q8(chunks, ring,
                                                   scale_block, pm.node)
                return (yield from _all_gather_q8(qs, c, ring))
            table = pm.drive(record, program())[0]
        else:
            blocks = F.pad(chunks, (0, B * cb - c))
            table = torch.cat(_pipeline(
                pm, record, B,
                lambda b: _reduce_scatter_q8(
                    blocks[:, b * cb:(b + 1) * cb], ring, scale_block,
                    pm.node, b),
                lambda b, qs: _all_gather_q8(qs, cb, ring, b)), 1)[:, :c]
        flat = table.reshape(-1)[:m]
    return _mean_of(flat.reshape(x.shape), op, pm.K)


def _broadcast(payload: Sequence[torch.Tensor], leader: int,
               pm: ProcessMesh, kind: str):
    """Forward the leader's payload along each axis's ring in turn, a
    node adopting it on first arrival (the reference's adopt-first
    forwarding): on axis a the rings through a holder are those whose
    later coordinates are the leader's, each a chain from the holder, so
    K - 1 messages in all.  ``payload`` is this node's tuple (the shapes
    and dtypes every node receives into)."""
    lead = np.unravel_index(leader, pm.Ks)
    bufs = list(payload)
    for a, ring in enumerate(pm.rings):
        if ring.size == 1 or tuple(pm.coords[a + 1:]) != tuple(
                int(c) for c in lead[a + 1:]):
            continue
        d = (ring.pos - int(lead[a])) % ring.size
        if d > 0:
            recv = [_empty(p) for p in bufs]
            yield Hop(ring, [], recv, kind)
            bufs = recv
        if d < ring.size - 1:
            yield Hop(ring, bufs, [], kind)
    return tuple(bufs)


def ring_broadcast(x: torch.Tensor, leader: int, pm: ProcessMesh,
                   record: Record) -> torch.Tensor:
    """Node ``leader``'s (global index) ``x`` to every node over the
    forwarding chains, recorded as ``broadcast``: each forwarder hands
    nbytes to its send, so the nodes' mean is (K-1)/K·nbytes."""
    return pm.drive(record, _broadcast((x,), leader, pm, "broadcast"))[0][0]


def ring_broadcast_packed(payload: Sequence[torch.Tensor], leader: int,
                          pm: ProcessMesh, record: Record
                          ) -> Tuple[torch.Tensor, ...]:
    """:func:`ring_broadcast` of the leader's packed payload tuple, all
    arrays moving together, recorded as ``broadcast_packed``."""
    return pm.drive(record, _broadcast(payload, leader, pm,
                                       "broadcast_packed"))[0]


def _gather(payload: Sequence[torch.Tensor], pm: ProcessMesh, kind: str,
            bucket=None):
    """One ring circulation of this node's payload tuple per mesh axis,
    the last axis first (the reference's ``_circulate_packed``): -> the
    (K, ...) arrays in node order."""
    out = list(payload)
    for ring in reversed(pm.rings):
        K, i = ring.size, ring.pos
        stacks = [p.new_empty((K,) + tuple(p.shape)) for p in out]
        for s, p in zip(stacks, out):
            s[i] = p
        send = out
        for t in range(K - 1):
            recv = [_empty(p) for p in send]
            yield Hop(ring, send, recv, kind, bucket)
            for s, r in zip(stacks, recv):
                s[(i - t - 1) % K] = r
            send = recv
        out = stacks
    lead = len(pm.Ks)
    return tuple(p.reshape((-1,) + tuple(p.shape[lead:])) for p in out)


def all_gather(x: torch.Tensor, pm: ProcessMesh, record: Record,
               kind: str = "all_gather") -> torch.Tensor:
    """Every node's ``x`` by ring circulation -> (K, ...), node order."""
    return pm.drive(record, _gather((x,), pm, kind))[0][0]


def all_gather_packed(payload: Sequence[torch.Tensor], pm: ProcessMesh,
                      record: Record, bucket: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Ring all-gather of this node's packed payload tuple -> the (K, ...)
    table, recorded as ``all_gather_packed`` ((K-1)·Σ nbytes a node)."""
    return pm.drive(record, _gather(payload, pm, "all_gather_packed",
                                    bucket))[0]


def all_gather_packed_buckets(encode: Callable[[int], tuple], B: int,
                              pm: ProcessMesh, record: Record) -> list:
    """The bucketed packed gather: ``encode(b)`` is bucket b's payload;
    bucket b + 1 is encoded while bucket b circulates.  -> B tables, each
    recorded under its bucket."""
    return _pipeline(
        pm, record, B, lambda b: _compute(lambda: encode(b)),
        lambda b, p: _gather(p, pm, "all_gather_packed", b))
