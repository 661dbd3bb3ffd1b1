"""The exchange-plan IR (counterpart of ``repro.dist.plan``), for the six
methods (``none``, ``sparse_gd``, ``dgc``, ``lgc_ps``, ``lgc_rar``,
``lgc_rar_q8``) on the ``mesh``, ``ring``, ``ring_q8``, ``ring_hier`` and
``ring_packed`` transports, on one dp axis or several (``axis_sizes``),
with the exchanges bucketed or not (``Plan.wire_buckets``).

:func:`build_plan` compiles (config, layout, K, phase) into an ordered
tuple of typed exchange ops; :func:`execute` runs them against a transport
with per-op feed callbacks and checks that feeds and plan labels match
both ways; :func:`wire_terms_by_op` and :func:`rate_terms` price the same
op objects.  The sparse methods' exchanges are
:class:`PackedSparseExchange` ops and the lgc support an
:class:`IndexBroadcast`, each carrying its ``PackPlan``, as in the
reference: on ``ring_packed`` they move the packed payload, elsewhere the
exact f32 + int32 pairs (or the raw int32 index set).  ``lgc_ps`` adds
the PS ops (the innovations' all-gather while the AE trains, then the
leader's common encoding as a :class:`LeaderBroadcast` and the
innovations as a packed ``mode="gather"`` exchange); ``lgc_rar_q8``'s
encoding is a :class:`Reduce` with ``wire="q8"``, int8 on ``ring_q8``
and f32 elsewhere.  :func:`bucket_plan` prices one op as the executing
collective splits it (``<label>#b<i>`` rows per bucket), and
:func:`padding_overhead_terms` the part of its bytes that is padding, so
that accounted == ideal + overhead at every bucket count.  With
``cc.guard_checksum`` every PackPlan carries the checksum word, priced.

Under the transport's guard policy (``dist.chaos.GUARD_POLICIES``)
:func:`execute` scrubs each op's result (:func:`_guard_result`) and
counts, per node, the bad elements of the result and what the
transport's validators report into the op's sink; ``env["__guard__"]``
carries the (K,) counts per op and each node's ok, as each of the
reference's nodes holds its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CompressionConfig
from repro_torch.core import autoencoder as AE
from repro_torch.core.phases import (PHASE_COMPRESSED, PHASE_TOPK_AE,
                                     PHASE_WARMUP)
from repro_torch.core.sparsify import (GradientLayout, innovation_frac,
                                       innovation_k)
from repro_torch.dist import chaos as CH
from repro_torch.dist import collectives as C
from repro_torch.dist import packed as PK
from repro_torch.dist import quantize as Q

BYTES_F32 = 4
BYTES_I32 = 4

METHODS = ("none", "sparse_gd", "dgc", "lgc_ps", "lgc_rar", "lgc_rar_q8")


@dataclass(frozen=True)
class Op:
    label: str


@dataclass(frozen=True)
class DenseReduce(Op):
    """f32 allreduce of ``n_vals`` values; ``exempt`` marks the exempt
    layers' dense traffic (left out by the paper's own rate accounting)."""
    n_vals: int
    exempt: bool = False


@dataclass(frozen=True)
class Reduce(Op):
    """Allreduce (mean) of ``n_vals`` values; ``wire="q8"`` ships int8 +
    per-block f32 scales on ``ring_q8`` and f32 on every float wire."""
    n_vals: int
    wire: str = "f32"              # "f32" | "q8"


@dataclass(frozen=True)
class AllGather(Op):
    n_vals: int


@dataclass(frozen=True)
class SparseExchange(Op):
    """k (value, index) pairs over a length-``n_vec`` vector on the exact
    f32 + int32 wire; ``k_rate`` is what the paper's rate counts."""
    n_vec: int
    k: int
    k_rate: int


@dataclass(frozen=True)
class PackedSparseExchange(Op):
    """A SparseExchange that rides the packed wire on the packed ring
    transport; ``pack`` is its PackPlan (None when k == 0).  On every
    other wire it moves the exact pairs.  ``mode="mean"`` averages the
    scattered pairs, ``"gather"`` returns the (K, n_vec) per-node
    scatters."""
    n_vec: int
    k: int
    k_rate: int
    pack: Optional[PK.PackPlan]
    mode: str = "mean"             # "mean" | "gather"


@dataclass(frozen=True)
class IndexBroadcast(Op):
    """The rotating leader's sorted index set (k entries over [0, n_vec])
    to all nodes: the packed index payload (``pack``, bit-exact) on
    ``ring_packed``, a raw int32 broadcast elsewhere."""
    n_vec: int
    k: int
    k_rate: int
    pack: PK.PackPlan


@dataclass(frozen=True)
class LeaderBroadcast(Op):
    """The leader's ``n_vals`` f32 values to all nodes (the PS common
    encoding): wire cost (K-1)/K·nbytes, rate cost on the leader only."""
    n_vals: int


@dataclass(frozen=True)
class Plan:
    method: str
    phase: str
    transport: str
    K: int
    scale_block: int
    ops: Tuple[Op, ...]
    # buckets per ring exchange (1 = unbucketed): the pricers predict the
    # per-bucket rows the executor records
    wire_buckets: int = 1

    @property
    def labels(self) -> Tuple[str, ...]:
        return tuple(op.label for op in self.ops)


def steady_phase(method: str) -> str:
    """The phase a method spends training in, which the rate prices."""
    if method == "none":
        return PHASE_WARMUP
    if method in ("sparse_gd", "dgc"):
        return PHASE_TOPK_AE
    return PHASE_COMPRESSED


def build_plan(cc: CompressionConfig, layout: GradientLayout, K: int,
               transport: Optional[str] = None,
               phase: Optional[str] = None) -> Plan:
    method = cc.method
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; known: {METHODS}")
    tkind = transport if transport is not None else (cc.transport or "mesh")
    # a chaos:<base> wire moves what its base moves (the reference prices
    # the prefixed name as a float wire in its rate report)
    tkind = tkind.split(":", 1)[-1]
    phase = phase if phase is not None else steady_phase(method)
    sb = cc.q8_scale_block or Q.SCALE_BLOCK
    n = layout.n_total

    def _plan(ops) -> Plan:
        return Plan(method=method, phase=phase, transport=tkind, K=K,
                    scale_block=sb, ops=tuple(ops),
                    wire_buckets=cc.wire_buckets or 1)

    if phase == PHASE_WARMUP or method == "none":
        return _plan([DenseReduce("grad", n_vals=n)])
    packed = method in PK.PACKED_METHODS
    chk = cc.guard_checksum

    def sparse(label, n_vec, k, k_rate, mode="mean"):
        if packed:
            return PackedSparseExchange(
                label, n_vec=n_vec, k=k, k_rate=k_rate,
                pack=PK.make_plan(n_vec, k, sb, checksum=chk) if k else None,
                mode=mode)
        return SparseExchange(label, n_vec=n_vec, k=k, k_rate=k_rate)

    mp = layout.mu_pad
    ops = [DenseReduce("exempt_dense",
                       n_vals=sum(l.size for l in layout.dense), exempt=True),
           sparse("exempt_last", n, layout.k_last, layout.k_last)]
    if method in ("sparse_gd", "dgc"):
        # the whole cross-node exchange: mu_pad shipped pairs, mu counted
        ops.append(sparse("topk", n, mp, layout.mu))
        return _plan(ops)
    ops.append(IndexBroadcast("support", n_vec=n, k=mp, k_rate=layout.mu,
                              pack=PK.make_plan(n, mp, sb, checksum=chk)))
    zl = AE.compressed_length(mp)
    if phase == PHASE_TOPK_AE:
        ops.append(Reduce("support_vals", n_vals=mp))
        ops.append(AllGather("gather_vals", n_vals=mp))
        if method == "lgc_ps":
            ops.append(AllGather("gather_inno", n_vals=mp))
    elif method == "lgc_ps":
        k_inv = innovation_k(mp, innovation_frac(cc.innovation_sparsity,
                                                 cc.sparsity))
        ops.append(LeaderBroadcast("z_common", n_vals=zl))
        ops.append(sparse("innovations", mp, k_inv, k_inv, mode="gather"))
    else:
        ops.append(Reduce("encoding", n_vals=zl,
                          wire="q8" if method == "lgc_rar_q8" else "f32"))
    return _plan(ops)


def _run_op(op: Op, t, args: tuple):
    if isinstance(op, Reduce) and op.wire == "q8":
        return t.mean_q8(*args)
    if isinstance(op, (DenseReduce, Reduce)):
        return t.mean(*args)
    if isinstance(op, AllGather):
        return t.all_gather(*args)
    if isinstance(op, SparseExchange):
        vals, idx = args
        return t.sparse_mean(vals, idx, op.n_vec)
    if isinstance(op, PackedSparseExchange):
        vals, idx = args
        if op.mode == "gather":
            return t.sparse_gather_packed(vals, idx, op.n_vec, plan=op.pack)
        return t.sparse_mean_packed(vals, idx, op.n_vec, plan=op.pack)
    if isinstance(op, IndexBroadcast):
        idx, leader = args
        return t.broadcast_packed(idx, leader, op.n_vec, plan=op.pack)
    if isinstance(op, LeaderBroadcast):
        x, leader = args
        return t.from_leader(x, leader)
    raise TypeError(op)


def _guard_result(op: Op, res: torch.Tensor, args: tuple):
    """One op's result under a guard -> (scrubbed result, bad count).
    Float elements that are non-finite or have |x| > ``chaos.GUARD_MAX``
    are zeroed and counted: the compressor clears u, v only where the
    round was clean, so what was zeroed ships again.  The zeroing is in
    place unless the result shares storage with the op's arguments (an
    all_gather or a broadcast may hand a feed's tensor back).  An
    IndexBroadcast result with entries outside [0, n_vec] or out of order
    is clipped and sorted again, each such entry counted."""
    if isinstance(op, IndexBroadcast):
        bad = ((res < 0) | (res > op.n_vec)).sum()
        if res.shape[0] > 1:
            bad = bad + (res[1:] < res[:-1]).sum()
        fixed = torch.sort(res.clamp(0, op.n_vec))[0]
        return torch.where(bad > 0, fixed, res), bad
    if res.is_floating_point():
        # NaN fails both comparisons, +-inf one of them
        mask = res.le(CH.GUARD_MAX).logical_and_(res.ge(-CH.GUARD_MAX)) \
            .logical_not_()
        ptr = res.untyped_storage().data_ptr()
        shared = any(isinstance(a, torch.Tensor)
                     and a.untyped_storage().data_ptr() == ptr
                     for a in args)
        res = res.masked_fill(mask, 0) if shared \
            else res.masked_fill_(mask, 0)
        return res, mask.sum()
    return res, torch.zeros((), dtype=torch.int64, device=res.device)


def execute(plan: Plan, t, feeds: Dict[str, Callable]) -> Dict[str, Any]:
    """Run ``plan.ops`` in order against transport ``t``.  ``feeds[label]
    (env)`` gives each op's arguments; ``env`` holds earlier ops' results
    (and memoized per-node values under underscore keys).  Every op needs
    exactly one feed and vice versa.  Each transport call runs under its
    op label, so the transport's tally attributes bytes to the op.

    The transport's ``guard`` other than "off" scrubs each result through
    :func:`_guard_result` and drains the counts the transport's
    validators report (``chaos.structural_sink``) into the op's (K,)
    per-node count; ``env["__guard__"]`` is then {"policy", "bad":
    {label: (K,) counts}, "ok": (K,) bool}, tensors on the result's
    device (nothing here waits for it).  The counts are per node held
    here (``t.nodes``): all K emulated, this process's one under a
    process group, a report's global node index taken to its row."""
    labels = set(plan.labels)
    missing, extra = labels - set(feeds), set(feeds) - labels
    if missing or extra:
        raise ValueError(f"plan/feeds mismatch for {plan.method}/"
                         f"{plan.phase}: missing feeds {sorted(missing)}, "
                         f"unplanned feeds {sorted(extra)}")
    guard = t.guard
    env: Dict[str, Any] = {}
    bad_by_op: Dict[str, torch.Tensor] = {}
    for op in plan.ops:
        args = feeds[op.label](env)
        if not isinstance(args, tuple):
            args = (args,)
        if guard == "off":
            with t.wire_op(op.label):
                env[op.label] = _run_op(op, t, args)
            continue
        sink: list = []
        with t.wire_op(op.label), CH.structural_sink(sink):
            res = _run_op(op, t, args)
        res, bad = _guard_result(op, res, args)
        held = t.nodes
        per_node = torch.zeros(len(held), dtype=torch.int64,
                               device=res.device) + bad
        for nodes, count in sink:
            if nodes is None:
                per_node += count
            else:
                # one node at a time: a list index would be copied to the
                # card, and a blocking copy waits for it
                for i in nodes:
                    if i in held:
                        per_node[held.index(i)] += count
        env[op.label] = res
        bad_by_op[op.label] = per_node
    if guard != "off":
        env["__guard__"] = {"policy": guard, "bad": bad_by_op,
                            "ok": sum(bad_by_op.values()) == 0}
    return env


WIRE_TRANSPORTS = ("mesh", "ring", "ring_q8", "ring_hier", "ring_packed")


def bucket_plan(op: Op, n_buckets: int, tkind: str, Ks: Tuple[int, ...],
                K: int, sb: int = Q.SCALE_BLOCK
                ) -> Dict[str, Dict[str, float]]:
    """{row label: {collective kind: bytes}} one op moves per node, as the
    reference's ``bucket_plan`` prices it: the op's own label unbucketed,
    one ``<label>#b<i>`` row per bucket where the executing collective
    buckets (:func:`collectives.bucket_widths` of each ring's chunk
    columns; of the two-axis hierarchical ring's inter columns, three or
    more axes unbucketed; of the packed gather's sorted pairs, each
    bucket a ``packed.bucket_plan`` payload).  ``mesh`` is the lax
    collectives (all_reduce 2(K-1)/K of the buffer, all_gather (K-1)
    buffers, broadcast (K-1)/K) and never buckets; ``ring`` reduces
    through one chunked ring per axis of ``Ks``; ``ring_hier`` through
    the intra/inter levels; ``ring_q8`` moves a q8 reduction's chunks as
    int8 + scales (``sb`` values per scale); ``ring_packed`` adds the
    packed payloads of the packed exchanges and the index broadcast.
    Everywhere else a packed exchange moves its exact pairs."""
    if tkind not in WIRE_TRANSPORTS:
        raise ValueError(f"no pricing for transport {tkind!r}; known: "
                         f"{WIRE_TRANSPORTS}")
    out: Dict[str, Dict[str, float]] = {}

    def add(bucket: Optional[int], kind: str, b: float) -> None:
        if b:
            lbl = op.label if bucket is None else f"{op.label}#b{bucket}"
            row = out.setdefault(lbl, {})
            row[kind] = row.get(kind, 0.0) + float(b)

    mesh = tkind == "mesh"
    WB = 1 if mesh else max(int(n_buckets), 1)

    def ring(kind: str, n_vals: int, nbytes) -> None:
        # one ring per axis, each over the whole vector
        for Ka in Ks:
            if Ka > 1:
                c = -(-n_vals // Ka)
                B, cb = C.bucket_widths(c, WB)
                if B == 1:
                    add(None, kind, 2 * (Ka - 1) * nbytes(c))
                else:
                    for b in range(B):
                        add(b, kind, 2 * (Ka - 1) * nbytes(cb))

    def reduce_f32(n_vals: int) -> None:
        if n_vals <= 0:
            return
        if mesh:
            add(None, "all_reduce", 2 * (K - 1) / K * n_vals * BYTES_F32)
        elif tkind == "ring_hier" and len(Ks) > 1:
            K1, Ka = Ks[-1], Ks[0]
            c = -(-n_vals // K1)
            B, cab = C.bucket_widths(-(-c // Ka), WB) if len(Ks) == 2 \
                else (1, 0)
            if B == 1:
                if K1 > 1:
                    add(None, "ring_hier_intra",
                        2 * (K1 - 1) * c * BYTES_F32)
                for Ki in Ks[:-1]:
                    if Ki > 1:
                        add(None, "ring_hier_inter",
                            2 * (Ki - 1) * -(-c // Ki) * BYTES_F32)
            else:
                for b in range(B):
                    if K1 > 1:
                        add(b, "ring_hier_intra",
                            2 * (K1 - 1) * Ka * cab * BYTES_F32)
                    if Ka > 1:
                        add(b, "ring_hier_inter",
                            2 * (Ka - 1) * cab * BYTES_F32)
        else:
            ring("ring_allreduce", n_vals, lambda c: c * BYTES_F32)

    if isinstance(op, Reduce) and op.wire == "q8" and tkind == "ring_q8":
        ring("ring_allreduce_q8", op.n_vals,
             lambda c: Q.wire_nbytes(c, sb))
    elif isinstance(op, (DenseReduce, Reduce)):
        reduce_f32(op.n_vals)
    elif isinstance(op, AllGather):
        add(None, "all_gather", (K - 1) * op.n_vals * BYTES_F32)
    elif isinstance(op, PackedSparseExchange) and tkind == "ring_packed":
        if op.k > 0:
            B, kb = (1, op.k) if op.pack.raw_index else \
                C.bucket_widths(op.k, WB)
            if B == 1:
                add(None, "all_gather_packed",
                    (K - 1) * PK.wire_nbytes(op.pack))
            else:
                sub = PK.bucket_plan(op.pack, kb)
                for b in range(B):
                    add(b, "all_gather_packed",
                        (K - 1) * PK.wire_nbytes(sub))
    elif isinstance(op, (SparseExchange, PackedSparseExchange)):
        if op.k > 0:
            add(None, "all_gather", (K - 1) * op.k * (BYTES_F32 + BYTES_I32))
    elif isinstance(op, IndexBroadcast):
        if tkind == "ring_packed":
            add(None, "broadcast_packed",
                (K - 1) / K * PK.index_nbytes(op.pack))
        else:
            add(None, "broadcast", (K - 1) / K * op.k * BYTES_I32)
    elif isinstance(op, LeaderBroadcast):
        add(None, "broadcast", (K - 1) / K * op.n_vals * BYTES_F32)
    else:
        raise TypeError(op)
    return out


def _wire_ctx(plan: Plan, transport: Optional[str],
              axis_sizes: Optional[Sequence[int]],
              wire_buckets: Optional[int]):
    tkind = transport if transport is not None else plan.transport
    Ks = tuple(axis_sizes) if axis_sizes else (plan.K,)
    if int(np.prod(Ks)) != plan.K:
        raise ValueError(f"mesh shape {Ks} does not hold {plan.K} nodes")
    WB = wire_buckets if wire_buckets is not None else plan.wire_buckets
    return tkind, Ks, WB


def wire_terms_by_op(plan: Plan, transport: Optional[str] = None,
                     axis_sizes: Optional[Sequence[int]] = None,
                     wire_buckets: Optional[int] = None,
                     ) -> Dict[str, Dict[str, float]]:
    """{row label: {collective kind: bytes}}: what one executed step of
    the plan moves per node, op by op and, bucketed, bucket by bucket
    (ops that move nothing are omitted), on ``transport`` (default: the
    plan's) over a dp mesh of shape ``axis_sizes`` (default (K,)) with
    ``wire_buckets`` (default: the plan's)."""
    tkind, Ks, WB = _wire_ctx(plan, transport, axis_sizes, wire_buckets)
    out: Dict[str, Dict[str, float]] = {}
    for op in plan.ops:
        for lbl, terms in bucket_plan(op, WB, tkind, Ks, plan.K,
                                      plan.scale_block).items():
            row = out.setdefault(lbl, {})
            for kind, b in terms.items():
                row[kind] = row.get(kind, 0.0) + b
    return out


def wire_terms(plan: Plan, transport: Optional[str] = None,
               axis_sizes: Optional[Sequence[int]] = None,
               wire_buckets: Optional[int] = None) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for terms in wire_terms_by_op(plan, transport, axis_sizes,
                                  wire_buckets).values():
        for kind, b in terms.items():
            out[kind] = out.get(kind, 0.0) + b
    return out


def padding_overhead_terms(plan: Plan, transport: Optional[str] = None,
                           axis_sizes: Optional[Sequence[int]] = None,
                           wire_buckets: Optional[int] = None,
                           ) -> Dict[str, float]:
    """{op label: pad bytes}: the part of each op's accounted bytes that
    is padding (a ring's ceil-pad of its chunks, the bucket pad columns,
    the packed wire's per-bucket histograms and sentinel pairs), as
    accounted minus :func:`_op_ideal_bytes`; ops with no padding are
    omitted.  accounted == ideal + overhead at every bucket count."""
    tkind, Ks, WB = _wire_ctx(plan, transport, axis_sizes, wire_buckets)
    out: Dict[str, float] = {}
    for op in plan.ops:
        accounted = sum(sum(t.values()) for t in bucket_plan(
            op, WB, tkind, Ks, plan.K, plan.scale_block).values())
        pad = accounted - _op_ideal_bytes(op, tkind, Ks, plan.K,
                                          plan.scale_block)
        if pad > 1e-9:
            out[op.label] = pad
    return out


def _op_ideal_bytes(op: Op, tkind: str, Ks: Tuple[int, ...], K: int,
                    sb: int) -> float:
    """The pad-free wire bytes of one op: what it would move if every
    chunk split divided exactly (2(Ka-1)/Ka of the bytes per ring axis;
    the hierarchical ring's inter levels on 1/K1 of them; the packed
    gather at its parent PackPlan).  Gathers, broadcasts and ``mesh``
    move exactly-sized payloads: ideal == accounted."""
    def exact() -> float:
        return sum(sum(t.values()) for t in
                   bucket_plan(op, 1, tkind, Ks, K, sb).values())

    def ring_ideal(n_vals: float, per_val: float) -> float:
        if n_vals <= 0:
            return 0.0
        if tkind == "ring_hier" and len(Ks) > 1:
            K1 = Ks[-1]
            total = 2 * (K1 - 1) / K1 * n_vals * per_val
            for Ka in Ks[:-1]:
                total += 2 * (Ka - 1) / Ka * (n_vals / K1) * per_val
            return total
        return sum(2 * (Ka - 1) / Ka * n_vals * per_val
                   for Ka in Ks if Ka > 1)

    if tkind == "mesh":
        return exact()
    if isinstance(op, Reduce) and op.wire == "q8" and tkind == "ring_q8":
        return ring_ideal(op.n_vals, 1.0 + 4.0 / sb)
    if isinstance(op, (DenseReduce, Reduce)):
        return ring_ideal(op.n_vals, BYTES_F32)
    if isinstance(op, PackedSparseExchange) and op.k > 0 \
            and tkind == "ring_packed":
        return float((K - 1) * PK.wire_nbytes(op.pack))
    return exact()


def _op_rate_bytes(op: Op, tkind: str, sb: int, idx: Optional[np.ndarray],
                   count_exempt: bool, deflate) -> Tuple[float, float]:
    """(leader_bytes, other_bytes) one op adds to a node's payload.  On
    ``ring_packed`` the packed exchanges and the index broadcast cost
    their real packed bytes, from the op's own PackPlan; elsewhere the
    index set is priced at its DEFLATE size.  A q8 reduction costs its
    int8 bytes on ``ring_q8``; a broadcast is paid by the leader alone."""
    if isinstance(op, DenseReduce):
        b = 0.0 if (op.exempt and not count_exempt) \
            else op.n_vals * BYTES_F32
        return b, b
    if isinstance(op, Reduce) and op.wire == "q8" and tkind == "ring_q8":
        b = float(Q.wire_nbytes(op.n_vals, sb))
        return b, b
    if isinstance(op, (Reduce, AllGather)):
        b = op.n_vals * BYTES_F32
        return b, b
    if isinstance(op, (SparseExchange, PackedSparseExchange)):
        if op.k <= 0:
            return 0.0, 0.0
        if isinstance(op, PackedSparseExchange) and tkind == "ring_packed":
            b = float(PK.wire_nbytes(op.pack))
        else:
            b = op.k_rate * BYTES_F32 + deflate(idx, op.k_rate, op.n_vec)
        return b, b
    if isinstance(op, IndexBroadcast):
        if tkind == "ring_packed":
            return float(PK.index_nbytes(op.pack)), 0.0
        return float(deflate(idx, op.k_rate, op.n_vec)), 0.0
    if isinstance(op, LeaderBroadcast):
        return op.n_vals * BYTES_F32, 0.0
    raise TypeError(op)


def rate_terms(plan: Plan, *, indices: Optional[np.ndarray] = None,
               inno_indices: Optional[np.ndarray] = None,
               count_exempt: bool = True, transport: Optional[str] = None,
               deflate=None) -> Tuple[float, float]:
    """(leader_bytes, other_bytes) per iteration: the paper-style rate of
    the plan's ops (leader-only terms are amortized by the caller),
    priced for ``transport`` (default: the plan's).  ``indices`` prices
    the top-k/support index set at its exact DEFLATE size on the float
    wires, ``inno_indices`` the PS innovation set."""
    if deflate is None:
        from repro_torch.core.rate import deflate_bytes as deflate
    tkind = transport if transport is not None else plan.transport
    leader = other = 0.0
    idx_of = {"topk": indices, "support": indices,
              "innovations": inno_indices}
    for op in plan.ops:
        lb, ob = _op_rate_bytes(op, tkind, plan.scale_block,
                                idx_of.get(op.label), count_exempt, deflate)
        leader += lb
        other += ob
    return leader, other
