"""End-to-end training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama3.2-1b --smoke --steps 6 --compression lgc_rar \
        --topk-backend fused --ae-backend pallas --data-shards 2 \
        --warmup-steps 2 --ae-train-steps 2 [--device cpu]

Runs the three-phase LGC schedule (warm-up -> top-k + online AE ->
compressed; sparse_gd and dgc: warm-up -> top-k) for every method of the
reference (``--compression none|sparse_gd|dgc|lgc_ps|lgc_rar|
lgc_rar_q8``) with the K data-parallel nodes emulated on one device over
the ``--transport`` wire (``mesh``, ``ring``, ``ring_q8``, ``ring_hier``
or ``ring_packed``, each also as ``chaos:<base>``), and logs what the
reference trainer logs: the per-phase loss, the rate report, and per
phase the wire bytes each node moves, per exchange op.  ``--pod-shards``
P > 1 makes the dp mesh (P, ``--data-shards``), K = P x data-shards
nodes, the two levels of ``ring_hier``; ``--wire-buckets`` B > 1 buckets
the ring exchanges.

The wire's failure behaviour: ``--fault-*`` injects seeded faults (and
wraps the wire in ``chaos:<base>``), ``--guard scrub|skip_round|
fail_fast`` validates every exchange (fail_fast raises
``WireFaultError`` after the step that saw a fault), and
``--guard-checksum`` adds the checksum word to every packed payload.
``--checkpoint-dir`` with ``--checkpoint-every`` saves the full train
state (params, optimizer moments and the compressor's state, its EF
residuals included) and ``--resume`` continues from such a file, bit for
bit as an uninterrupted run.  Runs on the card unless ``--device cpu``;
with no card it raises.  Flags follow ``repro.launch.train``.

Under torchrun each process is one node (``launch.mesh``: ``WORLD_SIZE``
must be pod x data shards), and every exchange of the wire runs between
the processes over ``torch.distributed`` (``dist.p2p``), the values and
per-op rows bitwise the emulated run's; ``--dist-backend gloo|nccl`` is
required (gloo stages the card's messages through pinned host memory, so
K processes may share one card):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --data-shards 2 --dist-backend gloo \
        --compression lgc_rar --transport ring ...

Rank 0 alone logs the rate report and the per-op rows and writes
``--metrics-out``; ``--report DIR`` has every process write its own
record.  The chaos wire, the guards and checkpointing do not run under a
process group yet (ROADMAP.md Queue 1 item 7b) and raise.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import (CompressionConfig, ModelConfig,
                                      TrainConfig)
from repro_torch.core.phases import phase_for_step
from repro_torch.core.rate import rate_report
from repro_torch.data import synthetic_token_batches
from repro_torch.dist import chaos
from repro_torch.dist.transport import PG_DEFERRED
from repro_torch.kernels import LAUNCHES
from repro_torch.launch.mesh import init_process_mesh, under_torchrun
from repro_torch.launch.steps import make_lgc_train_step
from repro_torch.models.model import build_model
from repro_torch.utils import (deterministic_convs, disable_tf32,
                               resolve_device)
from repro_torch.utils.tree import tree_digest

log = logging.getLogger("repro_torch.train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced (smoke) config variant")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--compression", default="none",
                   choices=["none", "sparse_gd", "dgc", "lgc_ps", "lgc_rar",
                            "lgc_rar_q8"])
    p.add_argument("--sparsity", type=float, default=0.001)
    transports = ["mesh", "ring", "ring_q8", "ring_hier", "ring_packed"]
    p.add_argument("--transport", default="mesh",
                   choices=transports + ["chaos:" + t for t in transports],
                   help="the wire between the nodes (emulated on one "
                        "device, or under torchrun between the processes): "
                        "mesh = the lax collectives, ring = "
                        "the chunked ring, ring_q8 = the ring with an int8 "
                        "q8 reduction (lgc_rar_q8's encoding), ring_hier = "
                        "the intra-/inter-pod rings (with --pod-shards), "
                        "ring_packed = the ring with the packed sparse "
                        "payloads.  A chaos:<base> prefix wraps the wire "
                        "in the seeded fault injector (--fault-*); any "
                        "--fault-* flag wraps it too")
    p.add_argument("--wire-buckets", type=int, default=1,
                   help="buckets per ring exchange (1 = unbucketed)")
    p.add_argument("--guard", default="off",
                   choices=["off", "scrub", "skip_round", "fail_fast"],
                   help="exchange guard policy (repro_torch.dist.chaos): "
                        "scrub zeroes non-finite or invalid wire payloads "
                        "(the masked gradient stays in the EF residual), "
                        "skip_round also drops a faulty round's whole "
                        "gradient, fail_fast raises WireFaultError naming "
                        "the faulting op labels")
    p.add_argument("--guard-checksum", action="store_true",
                   help="append one int32 checksum word to every packed "
                        "payload (+4 wire bytes, priced)")
    p.add_argument("--fault-seed", type=int, default=0)
    p.add_argument("--fault-bitflips", type=int, default=0,
                   help="XOR this many seeded bits into each targeted "
                        "op's result per step")
    p.add_argument("--fault-nans", type=int, default=0,
                   help="overwrite this many seeded result elements with "
                        "NaN per targeted op per step")
    p.add_argument("--fault-infs", type=int, default=0,
                   help="overwrite this many seeded result elements with "
                        "+inf per targeted op per step")
    p.add_argument("--fault-drop-node", type=int, default=-1,
                   help="this node's contribution to every targeted "
                        "collective becomes zeros")
    p.add_argument("--fault-stale-node", type=int, default=-1,
                   help="this node contributes a rolled (finite, wrong) "
                        "payload to every targeted collective")
    p.add_argument("--fault-ops", default="",
                   help="comma-separated exchange-plan op labels to target "
                        "(default: all ops)")
    p.add_argument("--topk-backend", default="jnp",
                   choices=["jnp", "pallas", "fused"],
                   help="residual top-k selection (pallas = the block "
                        "top-k kernel per leaf, fused = the one-launch "
                        "accumulate + select sweep kernel)")
    p.add_argument("--ae-backend", default="jnp", choices=["jnp", "pallas"],
                   help="phase-3 encoder (pallas = im2col + the fused "
                        "matmul kernel)")
    p.add_argument("--extract-backend", default="auto",
                   choices=["auto", "loop", "bitonic"],
                   help="the reference's per-block extractor, which picks "
                        "the sweep's block size")
    p.add_argument("--warmup-steps", type=int, default=10)
    p.add_argument("--ae-train-steps", type=int, default=15)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "sgd_momentum"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--data-shards", type=int, default=1,
                   help="data-parallel nodes per pod (emulated, or under "
                        "torchrun one process each)")
    p.add_argument("--pod-shards", type=int, default=1,
                   help="pods: the dp mesh becomes (pod x data), K = pod "
                        "x data nodes, the two levels of ring_hier")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default="",
                   help="checkpoint .npz to resume from: restores the full "
                        "train state, EF residuals included, fast-forwards "
                        "the data stream and continues at the saved step, "
                        "bit for bit as an uninterrupted run")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--metrics-out", default="")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                   help="under torchrun (one node per process): the "
                        "process group's backend, no default.  gloo "
                        "stages the card's messages through pinned host "
                        "memory (several ranks may share a card); nccl "
                        "needs a card per rank")
    p.add_argument("--dist-init", default="env://",
                   help="under torchrun: the process group's rendezvous "
                        "(init_process_group's init_method), env:// as "
                        "torchrun sets it or file:///path")
    p.add_argument("--report", default="",
                   help="directory: each process writes rank<r>.json, its "
                        "steps, per-op wire rows (and, under torchrun, the "
                        "bytes and messages it sent), a sha256 of its "
                        "final params and AE, peak GiB and kernel "
                        "launches")
    return p.parse_args(argv)


def refuse_deferred(args, cc: CompressionConfig) -> None:
    """Raise for what does not run under a process group yet, naming
    the item that ports it."""
    bad = []
    if args.transport.startswith("chaos:") \
            or chaos.spec_from_config(cc) is not None:
        bad.append("the chaos wire (chaos:<base>, --fault-*)")
    if args.guard != "off":
        bad.append(f"--guard {args.guard}")
    if args.checkpoint_dir or args.checkpoint_every:
        bad.append("--checkpoint-dir/--checkpoint-every")
    if args.resume:
        bad.append("--resume")
    if bad:
        raise NotImplementedError(
            f"{'; '.join(bad)} under a process group (torchrun) is "
            f"{PG_DEFERRED}: the chaos wire, guards and checkpoint/resume "
            f"across processes")


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: token ids as int64, the encoder
    embeddings as they are (f32)."""
    out = {}
    for k, x in batch.items():
        t = torch.from_numpy(x).to(device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def _state_tree(cc: CompressionConfig, params, opt_state, comp_state):
    """What a checkpoint holds: the full train state, without the
    compressor's for ``none`` (the reference's dense trainer has none)."""
    tree = {"params": params, "opt_state": opt_state}
    if cc.method != "none":
        tree["comp_state"] = comp_state
    return tree


def run(cfg: ModelConfig, args,
        on_step: Optional[Callable[[Dict[str, Any]], None]] = None
        ) -> Dict[str, Any]:
    """Train ``cfg`` as ``args`` says; returns {"history": per-step
    records (step, phase, loss, ms; with an MTP head mtp_loss; under a
    guard guard_ok, the step's
    fault counts per op label and the running total ``faults``; with
    injected faults the step's ``fault_ops``; ``checkpoint_s`` where the
    step saved), "wire": {phase: {op: {kind: bytes}}}, "rate": the
    RateReport, "compressor": the GradientCompressor, "params": the
    trained parameters, "resumed": {path, step, seconds} or None,
    "report": this process's ``--report`` record or None}.  Under
    torchrun the process is one node of the mesh.
    ``on_step(record)`` runs after each step has finished on the device
    and after its checkpoint."""
    disable_tf32()
    deterministic_convs()
    cc = CompressionConfig(method=args.compression, sparsity=args.sparsity,
                           warmup_steps=args.warmup_steps,
                           ae_train_steps=args.ae_train_steps,
                           transport=args.transport,
                           wire_buckets=args.wire_buckets,
                           guard=args.guard,
                           guard_checksum=args.guard_checksum,
                           fault_seed=args.fault_seed,
                           fault_bitflips=args.fault_bitflips,
                           fault_nans=args.fault_nans,
                           fault_infs=args.fault_infs,
                           fault_drop_node=args.fault_drop_node,
                           fault_stale_node=args.fault_stale_node,
                           fault_ops=args.fault_ops,
                           topk_backend=args.topk_backend,
                           ae_backend=args.ae_backend,
                           extract_backend=args.extract_backend)
    tc = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr,
                     steps=args.steps, seed=args.seed, compression=cc)
    Ks = (args.pod_shards, args.data_shards) if args.pod_shards > 1 \
        else (args.data_shards,)
    K = args.pod_shards * args.data_shards
    if not under_torchrun():
        if args.dist_backend:
            raise ValueError("--dist-backend is for a run under torchrun "
                             "(one node per process)")
        return _run(cfg, args, cc, tc, Ks, K, None,
                    resolve_device(args.device), on_step)
    refuse_deferred(args, cc)
    mesh = init_process_mesh(Ks, args.dist_backend, args.device,
                             args.dist_init)
    try:
        return _run(cfg, args, cc, tc, Ks, K, mesh, mesh.device, on_step)
    finally:
        dist.destroy_process_group()


def _run(cfg, args, cc, tc, Ks, K, mesh, device, on_step):
    rank0 = mesh is None or mesh.node == 0
    model = build_model(cfg)
    lts = make_lgc_train_step(model, tc, K, device, Ks, mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, opt_state, comp_state = lts.init(gen)
    layout = lts.compressor.layout
    if rank0:
        log.info("arch=%s params=%s device=%s nodes=%d mesh=%s%s", cfg.name,
                 f"{layout.n_total:,}", device, K, Ks,
                 "" if mesh is None else
                 f" one per process ({mesh.backend})")
    start, resumed = 0, None
    if args.resume:
        # the fresh state is the template: shapes, dtypes and the device
        t0 = time.perf_counter()
        loaded, start = load_checkpoint(
            args.resume, _state_tree(cc, params, opt_state, comp_state))
        params, opt_state = loaded["params"], loaded["opt_state"]
        comp_state = loaded.get("comp_state", comp_state)
        del loaded
        resumed = {"path": args.resume, "step": start,
                   "seconds": time.perf_counter() - t0}
        log.info("resumed the full train state from %s at step %d",
                 args.resume, start)
    report = rate_report(cc, layout, K)
    if rank0:
        log.info("compression=%s CR(avg)=%.1fx bytes/node=%.0f", cc.method,
                 report.compression_ratio, report.bytes_per_node)

    data = synthetic_token_batches(
        cfg.vocab_size, args.batch, args.seq, seed=args.seed,
        encoder_tokens=cfg.num_encoder_tokens, encoder_dim=cfg.encoder_dim)
    for _ in range(start):
        # step s trains on the stream's s-th batch, resumed or not
        next(data)
    ckpt = os.path.join(args.checkpoint_dir, "ckpt.npz")
    guard_on, faults = cc.guard != "off", 0
    history, wire, sent = [], {}, {}
    for step in range(start, args.steps):
        phase = phase_for_step(step, cc)
        batch = to_device(next(data), device)
        chaos.reset_fault_tally()
        t0 = time.perf_counter()
        params, opt_state, comp_state, metrics = lts.step(
            params, opt_state, comp_state, batch, step, phase)
        loss = float(metrics["loss"])            # waits for the device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": step, "phase": phase, "loss": loss, "ms": ms}
        if "mtp_loss" in metrics:
            rec["mtp_loss"] = float(metrics["mtp_loss"])
        if guard_on:
            # the guard's counts stay on the device through the step
            counts = {k[len("fault/"):]: int(v) for k, v in metrics.items()
                      if k.startswith("fault/")}
            faults += sum(counts.values())
            rec.update(guard_ok=int(metrics["guard_ok"]), fault=counts,
                       faults=faults)
        if chaos.fault_report():
            rec["fault_ops"] = chaos.fault_report()
        history.append(rec)
        if phase not in wire:
            wire[phase] = metrics["wire"]
            if "wire_sent" in metrics:
                sent[phase] = {"bytes": metrics["wire_sent"],
                               "messages": metrics["wire_messages"]}
            if rank0:
                log.info("phase=%s wire bytes/node/step by op: %s", phase,
                         {op: {k: int(b) for k, b in row.items()}
                          for op, row in metrics["wire"].items()})
        if rank0 and (step % args.log_every == 0
                      or step == args.steps - 1):
            log.info("step %4d  phase=%-10s loss=%.4f%s  %.1f ms", step,
                     phase, loss, f"  mtp_loss={rec['mtp_loss']:.4f}"
                     if "mtp_loss" in rec else "", ms)
        if cc.guard == "fail_fast":
            chaos.raise_on_faults(metrics, step=step)
        if args.checkpoint_every and args.checkpoint_dir \
                and step and step % args.checkpoint_every == 0:
            # step + 1: the next step to run on resume
            t0 = time.perf_counter()
            save_checkpoint(ckpt, _state_tree(cc, params, opt_state,
                                              comp_state), step + 1)
            rec["checkpoint_s"] = time.perf_counter() - t0
        if on_step is not None:
            on_step(rec)
    if args.checkpoint_dir:
        save_checkpoint(ckpt, _state_tree(cc, params, opt_state,
                                          comp_state), args.steps)
    if args.metrics_out and rank0:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    record = None
    if args.report:
        record = _report(args, mesh, device, history, wire, sent, params,
                         comp_state)
    return {"history": history, "wire": wire, "rate": report,
            "compressor": lts.compressor, "params": params,
            "resumed": resumed, "report": record}


def _report(args, mesh, device, history, wire, sent, params, comp_state):
    """This process's record, written to ``args.report``/rank<r>.json."""
    rank = 0 if mesh is None else mesh.node
    digest, leaves = tree_digest({"params": params, **{
        k: comp_state[k] for k in ("ae", "ae_mom") if k in comp_state}})
    record = {
        "rank": rank, "mesh": None if mesh is None else list(mesh.Ks),
        "history": history, "wire": wire, "sent": sent or None,
        "digest": digest, "leaf_digests": leaves,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30
        if device.type == "cuda" else None,
        "launches": dict(LAUNCHES)}
    os.makedirs(args.report, exist_ok=True)
    with open(os.path.join(args.report, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    return record


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    return run(cfg, args)["history"]


if __name__ == "__main__":
    main()
