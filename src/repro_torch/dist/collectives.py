"""The ring schedules of ``repro.dist.collectives`` on the stacked node
axis.

The reference runs its rings as ``shard_map`` over K devices, one
``ppermute`` per hop, node s sending to s + 1.  Here the K nodes are the
leading axis of one (K, ...) tensor on one device, and a hop is
``torch.roll(send, 1)`` along the node axis: row s moves to row s + 1.
The ring's order of additions and its bytes per hop are therefore the
reference's own.  Each collective records what one node puts on the wire
through ``record(kind, bytes)`` (a transport's per-op tally), under the
reference's tally kinds; a bucketed collective records one row per
bucket, ``record(kind, bytes, b)``, which the transport files under
``<op label>#b<b>``.

On a dp mesh of several axes, ``Ks`` = (K_pod, K_data) (any number of
axes, row-major, the last fastest), node ia·K_data + i1 is row (ia, i1)
of the (K_pod, K_data, ...) view: a hop on one axis is a roll along its
dimension, and the other axes are independent rings side by side.

Where every node ends a collective holding the same table (the
all-gather half of the allreduce, the packed all-gather, the
broadcasts), the emulation returns that table once instead of K copies;
it never skips an addition.  The reference's bucketed schedules
(``--wire-buckets`` > 1) software-pipeline their buckets
(``_sw_pipeline``) so that one bucket's hops overlap the next one's
encode; on one card there is no wire to overlap.  Bucketing changes the
order of the work, never the float rings' sums: each column keeps its
chunk row and columns never meet, so those rings are bitwise their
unbucketed selves, and here they run the unbucketed schedule and record
one row per bucket.  A bucket's pad columns hold zeros that the reference
ships and drops; they are priced (``dist.plan.padding_overhead_terms``).
Only where bucketing changes values, the int8 ring (its scale blocks
regroup per bucket) and the packed gather (``transport``), do the
buckets run, as a plain loop in the reference's order.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import chaos as CH
from repro_torch.dist import quantize as Q
from repro_torch.kernels.bitpack import f32_reciprocal

# record(kind, bytes) for an unbucketed exchange, record(kind, bytes, b)
# for bucket b of a bucketed one
Record = Callable[..., None]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def node_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading node axis as the reference computes it
    under ``jit``: the sum node after node, node 0 first (the order of
    XLA's reduce over a short leading axis), times f32(1/K).  XLA
    rewrites the division by the constant K into that multiplication, so
    ``x.mean(0)`` (a true division) differs from it by an ulp wherever
    1/K is not exact (K = 3, 5, ...)."""
    out = x[0]
    for k in range(1, x.shape[0]):
        out = out + x[k]
    return out * f32_reciprocal(x.shape[0], x.device)


def node_mean_q8(x: torch.Tensor, scale_block: int = Q.SCALE_BLOCK
                 ) -> torch.Tensor:
    """:func:`node_mean` of each node's int8 round trip (its values
    quantized and dequantized in its own scale blocks), as the reference's
    ``fake_quantize`` + ``mean`` compiles under ``jit``: XLA fuses each
    node's dequantize into the sum, so node k >= 1 is added as one FMA of
    its int8 values and scales."""
    n = x[0].numel()
    wire = []
    for k in range(x.shape[0]):
        with CH.on_node(k):
            wire.append(Q.quantize_i8(x[k], scale_block))
    out = Q.dequantize_i8(*wire[0], n)
    for q, s in wire[1:]:
        out = Q.dequantize_add_i8(q, s, n, out)
    return (out * f32_reciprocal(x.shape[0], x.device)).reshape(x.shape[1:])


def _mean_of(res: torch.Tensor, op: str, K: int) -> torch.Tensor:
    """``op="mean"``: ``res`` (a fresh tensor) times f32(1/K), in place,
    as the reference's division by K is compiled under ``jit``."""
    if op == "mean" and K > 1:
        res.mul_(f32_reciprocal(K, res.device))
    return res


def bucket_widths(c: int, n_buckets: int) -> Tuple[int, int]:
    """The bucket split rule the executor and the pricers share (the
    reference's ``collectives.bucket_widths``): ``c`` payload columns
    under ``n_buckets`` requested -> (B, cb), B buckets of cb columns with
    the payload padded to B·cb.  cb = ceil(c / min(n_buckets, c)), then
    B = ceil(c / cb) drops all-padding buckets, so every bucket carries a
    real column.  B == 1 is the unbucketed schedule."""
    if c <= 0:
        return 1, c
    B0 = max(1, min(int(n_buckets), c))
    cb = -(-c // B0)
    return -(-c // cb), cb


def _chunks(xn: torch.Tensor, K: int) -> torch.Tensor:
    """(..., m) -> (..., K, c): the values zero-padded to K·c, c =
    ceil(m/K), as K chunks."""
    pad = (-xn.shape[-1]) % K
    if pad:
        xn = F.pad(xn, (0, pad))
    return xn.reshape(xn.shape[:-1] + (K, -1))


def _reduce_scatter(chunks: torch.Tensor) -> torch.Tensor:
    """The ring's reduce-scatter on (..., K nodes, K chunks, c) -> (...,
    K, c), row j the fully reduced chunk j.  Node i starts from its chunk
    i; at hop t it receives its predecessor's partial sum and adds its
    own chunk (i - t - 1) mod K, so chunk j is summed in node order j, j +
    1, ..., j + K - 1 (mod K) and ends on node j - 1.  Leading dimensions
    are rings side by side."""
    K = chunks.shape[-3]
    send = torch.stack([chunks[..., i, i, :] for i in range(K)], -2)
    for t in range(K - 1):
        send = torch.roll(send, 1, -2)             # s -> s + 1
        for i in range(K):
            send[..., i, :] += chunks[..., i, (i - t - 1) % K, :]
    # node i holds the reduced chunk (i + 1) mod K: chunk j is send[j - 1]
    return torch.roll(send, 1, -2)


def _ring(xn: torch.Tensor, record: Record, kind: str,
          n_buckets: int = 1) -> torch.Tensor:
    """The full ring allreduce along the node axis (dim -2) of ``xn``
    (..., K, m) -> (..., m): the reduce-scatter, then the all-gather,
    which circulates the finished chunks unchanged and so leaves every
    node the same table.  Records 2(K-1)·c·itemsize per node under
    ``kind`` (c = ceil(m/K)); with B > 1 buckets (:func:`bucket_widths`
    of c), bucket b is columns [b·cb, (b+1)·cb) of the chunk matrix,
    recorded at 2(K-1)·cb·itemsize."""
    K, m = xn.shape[-2:]
    if K == 1:
        return xn[..., 0, :]
    chunks = _chunks(xn, K)                       # (..., K nodes, K, c)
    c, isz = chunks.shape[-1], xn.element_size()
    B, cb = bucket_widths(c, n_buckets)
    for b in range(B):
        record(kind, 2 * (K - 1) * cb * isz, *((b,) if B > 1 else ()))
    return _reduce_scatter(chunks).flatten(-2)[..., :m]


def ring_allreduce(x: torch.Tensor, record: Record, op: str = "add",
                   Ks: Optional[Sequence[int]] = None, n_buckets: int = 1
                   ) -> torch.Tensor:
    """The chunked ring allreduce of per-node ``x`` (K, ...) -> the global
    (...) result (:func:`_ring`), recorded as ``ring_allreduce``.  On a
    mesh of several dp axes ``Ks`` it chains one full ring per axis, the
    first axis first, each over the whole vector (the reference's
    ``ring_allreduce_multi``).  ``op="mean"`` multiplies by f32(1/K) once
    at the end.  ``n_buckets`` > 1 buckets every ring's columns; the
    result is bitwise the unbucketed one."""
    assert op in ("add", "mean"), op
    K = x.shape[0]
    if K == 1:
        return x[0].clone()
    xs = x.reshape(tuple(Ks or (K,)) + (-1,))
    for _ in range(xs.dim() - 1):
        xs = _ring(xs.movedim(0, -2), record, "ring_allreduce", n_buckets)
    return _mean_of(xs.reshape(x.shape[1:]), op, K)


def hierarchical_ring_allreduce(x: torch.Tensor, Ks: Sequence[int],
                                record: Record, op: str = "add",
                                n_buckets: int = 1) -> torch.Tensor:
    """The reference's ``hierarchical_ring_allreduce`` on the stacked
    (*Ks) node grid, the last axis intra-pod: the intra-pod
    reduce-scatter leaves node (ia, i1) its pod's reduced chunk (i1 + 1)
    mod K1 (c = ceil(n/K1) values); that shard is ring-allreduced over
    each inter-pod axis in turn (recorded as ``ring_hier_inter``,
    2(Ka-1)·ceil(c/Ka)·itemsize); the intra-pod all-gather then leaves
    every node the table (``ring_hier_intra``, 2(K1-1)·c·itemsize).  With
    one axis it is :func:`ring_allreduce`, the same schedule.
    ``op="mean"`` multiplies by f32(1/K) at the end.  The reference's
    per-level message caps (``ring_intra_chunk`` / ``ring_inter_chunk``)
    change neither values nor bytes on the stacked axis, so it takes
    none; across processes (``dist.p2p``) they set the messages' sizes.

    ``n_buckets`` > 1 on two axes: bucket b is inter columns [b·cab,
    (b+1)·cab) of every inter chunk row, recorded per bucket at
    2(K1-1)·Ka·cab and 2(Ka-1)·cab values; each element keeps its chunk
    row at both levels, so the values are the unbucketed ones.  With three
    or more axes it runs unbucketed, as the reference does."""
    assert op in ("add", "mean"), op
    Ks = tuple(Ks)
    K = x.shape[0]
    if len(Ks) == 1:
        return ring_allreduce(x, record, op, n_buckets=n_buckets)
    Ka, K1 = Ks[0], Ks[-1]
    xs = x.reshape(Ks + (-1,))
    n = xs.shape[-1]
    chunks = _chunks(xs, K1)                  # (*Ks, K1 chunks, c)
    c, isz = chunks.shape[-1], x.element_size()
    ca = -(-c // Ka)
    nb = n_buckets if len(Ks) == 2 else 1
    B, cab = bucket_widths(ca, nb)
    if K1 > 1 and B == 1:
        record("ring_hier_intra", 2 * (K1 - 1) * c * isz)
    elif K1 > 1:
        for b in range(B):
            record("ring_hier_intra", 2 * (K1 - 1) * Ka * cab * isz, b)
    shard = _reduce_scatter(chunks)               # (*Ks[:-1], K1, c)
    for _ in Ks[:-1]:       # the inter rows: _ring buckets ca as above
        shard = _ring(shard.movedim(0, -2), record, "ring_hier_inter", nb)
    return _mean_of(shard.reshape(-1)[:n].reshape(x.shape[1:]), op, K)


def _q8_table(chunks: torch.Tensor, scale_block: int,
              nodes) -> torch.Tensor:
    """The int8 ring on one (K nodes, K chunks, w) chunk matrix -> (K, w),
    row j chunk j as every node decodes it.  Reduce-scatter as
    :func:`_reduce_scatter`, but each node quantizes its partial chunk
    before the hop and the receiver dequantizes it into its own chunk (i -
    t - 1) mod K, product and sum one FMA as XLA compiles the reference's;
    the finished chunk is quantized once and that payload circulates
    unchanged, so every node decodes the same value.  Scale blocks are
    per chunk.  ``nodes[i]``: the node(s) at ring position i, whose
    quantizer counts a guard's sink gets."""
    K, w = chunks.shape[0], chunks.shape[-1]

    def quantize(i, x):
        with CH.on_node(nodes[i]):
            return Q.quantize_i8(x, scale_block)

    send = [chunks[i, i] for i in range(K)]
    for t in range(K - 1):
        wire = [quantize(i, s) for i, s in enumerate(send)]
        # node i receives node i - 1's payload (a roll of the node axis)
        send = [Q.dequantize_add_i8(*wire[(i - 1) % K], w,
                                    chunks[i, (i - t - 1) % K])
                for i in range(K)]
    # node i holds the finished chunk (i + 1) mod K, quantized once
    out = chunks.new_empty((K, w))
    for i in range(K):
        out[(i + 1) % K] = Q.dequantize_i8(*quantize(i, send[i]), w)
    return out


def _ring_q8(xn: torch.Tensor, record: Record, scale_block: int,
             n_buckets: int, nodes: np.ndarray) -> torch.Tensor:
    """:func:`_ring` on the int8 wire, (..., K, m) f32 -> (..., m), ring
    after ring for the leading dimensions; ``nodes[r, i]`` the node(s) at
    position i of ring r.  Records 2(K-1)·wire_nbytes(c) per node, or per
    bucket 2(K-1)·wire_nbytes(cb): the scale blocks regroup per bucket.
    At K = 1 nothing moves, and each node's value still makes one
    quantize -> dequantize round trip."""
    K, m = xn.shape[-2:]
    lead, rows = xn.shape[:-2], xn.reshape((-1, K, m))
    if K == 1:
        out = []
        for r, row in enumerate(rows):
            with CH.on_node(nodes[r, 0]):
                out.append(Q.fake_quantize(row[0], scale_block))
        return torch.stack(out).reshape(lead + (m,))
    c = -(-m // K)
    B, cb = bucket_widths(c, n_buckets)
    if B == 1:
        record("ring_allreduce_q8",
               2 * (K - 1) * Q.wire_nbytes(c, scale_block))
    else:
        for b in range(B):
            record("ring_allreduce_q8",
                   2 * (K - 1) * Q.wire_nbytes(cb, scale_block), b)
    out = []
    for r, row in enumerate(rows):
        ch = _chunks(row, K)                            # (K, K, c)
        table = torch.cat([_q8_table(ch[..., lo:min(lo + cb, c)],
                                     scale_block, nodes[r])
                           for lo in range(0, c, cb)], -1)
        out.append(table.reshape(-1)[:m])
    return torch.stack(out).reshape(lead + (m,))


def ring_allreduce_q8(x: torch.Tensor, record: Record, op: str = "add",
                      scale_block: int = Q.SCALE_BLOCK,
                      Ks: Optional[Sequence[int]] = None,
                      n_buckets: int = 1) -> torch.Tensor:
    """The int8 ring allreduce of per-node ``x`` (K, ...) -> the global
    (...) result, whose hops carry int8 values + one f32 scale per
    ``scale_block`` values (:func:`_ring_q8`), recorded as
    ``ring_allreduce_q8``.  On several dp axes ``Ks``, one int8 ring per
    axis in turn (the reference's ``ring_allreduce_q8_multi``).
    ``op="mean"`` multiplies by f32(1/K) at the end, after the sums.
    Bucketed, the scale blocks regroup per bucket: the result is the
    reference's bucketed one, not its unbucketed one."""
    assert op in ("add", "mean"), op
    K = x.shape[0]
    Ks = tuple(Ks or (K,))
    xs = x.to(torch.float32).reshape(Ks + (-1,))
    grid = np.arange(K).reshape(Ks)
    for a in range(len(Ks)):
        # ring r, position i of axis a: the nodes at (any earlier axes, i,
        # r's coordinates on the later axes), which hold the same value
        sub = grid.reshape((-1,) + Ks[a:])
        nodes = np.moveaxis(sub, 1, -1).reshape(sub.shape[0], -1, Ks[a]
                                                ).transpose(1, 2, 0)
        xs = _ring_q8(xs.movedim(0, -2), record, scale_block, n_buckets,
                      nodes)
    return _mean_of(xs.reshape(x.shape[1:]), op, K)


def ring_broadcast(x: torch.Tensor, leader: int, record: Record
                   ) -> torch.Tensor:
    """The leader's row of ``x`` (K, ...) to every node: K - 1 forwarding
    hops in which a node adopts the first payload to reach it, recorded
    at broadcast cost, (K-1)/K·nbytes per node."""
    K = x.shape[0]
    record("broadcast", (K - 1) / K * _nbytes(x[0]))
    return x[leader]


def all_gather_packed(payloads: Sequence[Tuple[torch.Tensor, ...]],
                      record: Record, bucket: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Ring all-gather of each node's packed payload tuple (``payloads[i]``
    is node i's): K - 1 hops per node, recorded as ``all_gather_packed``
    at (K-1)·Σ nbytes per node (on several dp axes one circulation per
    axis, whose bytes sum to the same), under bucket ``bucket`` if given.
    Returns the (K, ...) table every node ends with, in node order."""
    nbytes = (len(payloads) - 1) * sum(_nbytes(a) for a in payloads[0])
    if bucket is None:
        record("all_gather_packed", nbytes)
    else:
        record("all_gather_packed", nbytes, bucket)
    return tuple(torch.stack(parts) for parts in zip(*payloads))


def ring_broadcast_packed(payload: Sequence[torch.Tensor], K: int,
                          record: Record) -> Tuple[torch.Tensor, ...]:
    """:func:`ring_broadcast` of the leader's packed payload tuple, all
    arrays moving together, recorded as ``broadcast_packed`` at
    (K-1)/K·Σ nbytes per node."""
    record("broadcast_packed",
           (K - 1) / K * sum(_nbytes(a) for a in payload))
    return tuple(payload)
