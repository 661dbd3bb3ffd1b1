"""The ring schedules of ``repro.dist.collectives`` on the stacked node
axis.

The reference runs its rings as ``shard_map`` over K devices, one
``ppermute`` per hop, node s sending to s + 1.  Here the K nodes are the
leading axis of one (K, ...) tensor on one device, and a hop is
``torch.roll(send, 1, 0)``: row s moves to row s + 1.  The ring's order
of additions and its bytes per hop are therefore the reference's own.
Each collective records what one node puts on the wire through
``record(kind, bytes)`` (a transport's per-op tally), under the
reference's tally kinds.

Where every node ends a collective holding the same table (the
all-gather half of the allreduce, the packed all-gather, the
broadcasts), the emulation returns that table once instead of K copies;
it never skips an addition.  The reference's bucketed schedule
(``--wire-buckets`` > 1, its ``_sw_pipeline``) is not ported: ROADMAP.md
Queue 1, "multi-process NCCL transports".
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import quantize as Q
from repro_torch.kernels.bitpack import f32_reciprocal

Record = Callable[[str, float], None]


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
    wire = [Q.quantize_i8(x[k], scale_block) for k in range(x.shape[0])]
    out = Q.dequantize_i8(*wire[0], n)
    for q, s in wire[1:]:
        out = Q.dequantize_add_i8(q, s, n, out)
    return (out * f32_reciprocal(x.shape[0], x.device)).reshape(x.shape[1:])


def _to_chunks(x: torch.Tensor):
    """(K, ...) -> ((K nodes, K chunks, c), n): each node's values
    flattened and zero-padded to a multiple of K."""
    K = x.shape[0]
    flat = x.reshape(K, -1)
    n = flat.shape[1]
    pad = (-n) % K
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.view(K, K, -1), n


def ring_allreduce(x: torch.Tensor, record: Record, op: str = "add"
                   ) -> torch.Tensor:
    """The chunked ring allreduce of per-node ``x`` (K, ...) -> the
    global (...) result.  Reduce-scatter: node i starts from its chunk
    i; at hop t it receives its predecessor's partial sum and adds its
    own chunk (i - t - 1) mod K, so chunk c is summed in node order c,
    c + 1, ..., c + K - 1 (mod K) and ends on node c - 1.  The
    all-gather then circulates the finished chunks unchanged.  Records
    2(K-1)·c·itemsize per node as ``ring_allreduce``; ``op="mean"``
    multiplies by f32(1/K), as the reference's division by K does under
    ``jit``."""
    assert op in ("add", "mean"), op
    K = x.shape[0]
    if K == 1:
        return x[0].clone()
    chunks, n = _to_chunks(x)
    record("ring_allreduce",
           2 * (K - 1) * chunks.shape[2] * x.element_size())
    send = torch.stack([chunks[i, i] for i in range(K)])
    for t in range(K - 1):
        send = torch.roll(send, 1, 0)                  # s -> s + 1
        for i in range(K):
            send[i] += chunks[i, (i - t - 1) % K]
    # node i holds the reduced chunk (i + 1) mod K: chunk c is send[c - 1]
    out = torch.roll(send, 1, 0).reshape(-1)[:n].reshape(x.shape[1:])
    if op == "mean":
        out.mul_(f32_reciprocal(K, out.device))     # out is a fresh tensor
    return out


def ring_allreduce_q8(x: torch.Tensor, record: Record, op: str = "add",
                      scale_block: int = Q.SCALE_BLOCK) -> torch.Tensor:
    """The int8 ring allreduce of per-node ``x`` (K, ...) -> the global
    (...) result, whose hops carry int8 values + one f32 scale per
    ``scale_block`` values.  Reduce-scatter as :func:`ring_allreduce`,
    but each node quantizes its partial chunk before the hop and the
    receiver dequantizes it into its own chunk (i - t - 1) mod K, product
    and sum one FMA as XLA compiles the reference's; the finished chunk
    is quantized once and that payload circulates unchanged, so every
    node decodes the same value.  Scale blocks are per chunk.  Records
    2(K-1)·wire_nbytes(c) per node as ``ring_allreduce_q8``; ``op="mean"``
    multiplies by f32(1/K), as the reference's division by K does under
    ``jit``.  At K = 1 nothing moves, and the value still makes one
    quantize -> dequantize round trip."""
    assert op in ("add", "mean"), op
    K = x.shape[0]
    if K == 1:
        return Q.fake_quantize(x[0], scale_block)
    chunks, n = _to_chunks(x.to(torch.float32))
    c = chunks.shape[2]
    record("ring_allreduce_q8", 2 * (K - 1) * Q.wire_nbytes(c, scale_block))
    send = [chunks[i, i] for i in range(K)]
    for t in range(K - 1):
        wire = [Q.quantize_i8(s, scale_block) for s in send]
        # node i receives node i - 1's payload (a roll of the node axis)
        send = [Q.dequantize_add_i8(*wire[(i - 1) % K], c,
                                    chunks[i, (i - t - 1) % K])
                for i in range(K)]
    # node i holds the finished chunk (i + 1) mod K, quantized once
    out = torch.empty((K, c), dtype=torch.float32, device=x.device)
    for i in range(K):
        out[(i + 1) % K] = Q.dequantize_i8(*Q.quantize_i8(send[i],
                                                          scale_block), c)
    res = out.reshape(-1)[:n].reshape(x.shape[1:])
    if op == "mean":
        res.mul_(f32_reciprocal(K, res.device))
    return res


def ring_broadcast(x: torch.Tensor, leader: int, record: Record
                   ) -> torch.Tensor:
    """The leader's row of ``x`` (K, ...) to every node: K - 1 forwarding
    hops in which a node adopts the first payload to reach it, recorded
    at broadcast cost, (K-1)/K·nbytes per node."""
    K = x.shape[0]
    record("broadcast", (K - 1) / K * _nbytes(x[0]))
    return x[leader]


def all_gather_packed(payloads: Sequence[Tuple[torch.Tensor, ...]],
                      record: Record) -> Tuple[torch.Tensor, ...]:
    """Ring all-gather of each node's packed payload tuple (``payloads[i]``
    is node i's): K - 1 hops per node, recorded as ``all_gather_packed``
    at (K-1)·Σ nbytes per node.  Returns the (K, ...) table every node
    ends with, in node order."""
    K = len(payloads)
    record("all_gather_packed",
           (K - 1) * sum(_nbytes(a) for a in payloads[0]))
    return tuple(torch.stack(parts) for parts in zip(*payloads))


def ring_broadcast_packed(payload: Sequence[torch.Tensor], K: int,
                          record: Record) -> Tuple[torch.Tensor, ...]:
    """:func:`ring_broadcast` of the leader's packed payload tuple, all
    arrays moving together, recorded as ``broadcast_packed`` at
    (K-1)/K·Σ nbytes per node."""
    record("broadcast_packed",
           (K - 1) / K * sum(_nbytes(a) for a in payload))
    return tuple(payload)
