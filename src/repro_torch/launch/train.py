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
bit as an uninterrupted run.  The emulated run's file is the reference
trainer's ``ckpt.npz``, u and v as its (dp, mp, n) = (K, 1, n) (the (K,
n) stacks reshaped at the file boundary), so each package's trainer
resumes from the other's.  Runs on the card unless ``--device cpu``;
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
record.  The chaos wire, every ``--fault-*``, the guards and the checksum
word run as in the emulated run: each process's fault tally and guard
records are the emulated step's (node 0's counts, which every process
receives), and fail_fast raises on every process at the same step.

``--model-shards`` M > 1 (under torchrun only: one process holds one
model shard) makes the world the (pod, data, model) mesh, pod x data x M
processes; M is any size the reference's rules take, also one whose
shards cut a head (latent attention's too).  With a compression method
each process compresses its model shard's block of its node's gradient
over its shard's dp column (``launch.steps.make_lgc_train_step`` with a
grid: tensor parallelism over ``model``, the per-model-shard layout, the
AE's gradients averaged over ``model``).  Under torchrun ``--compression
none`` runs the reference's auto step at any M, as the reference's
trainer does (``use_lgc``): TP over ``model``, FSDP over ``data``, DP
over ``pod`` (``make_auto_train_step``); the emulated one-process run
keeps its K-node ``none`` through the LGC step, since one process holds
no shards.

Checkpoints under torchrun are one file a rank (``ckpt.rank<r>.npz``,
``checkpoint.save_rank_checkpoint``), on any grid: each holds the rank's
blocks of the gathered file's leaves under their specs
(``steps.train_state_specs``), written only by the rank at 0 on the dp
axes a leaf's spec does not split (the data-0 rank of each model column
its column's params, optimizer and AE; under FSDP every rank its data
blocks; every rank its own u, v), never deduplicated over ``model``: the
model shards' copies of a leaf the spec leaves whole (a norm scale)
differ, each shard compressing its own flat gradient.  ``--resume
<dir>/ckpt.npz`` reads the rank files when any is there (each rank its
own, the rest broadcast over dp; bit for bit the uninterrupted run, and
a torn, missing or foreign file makes every rank raise
``CheckpointError``), else the gathered file at that path, the
reference's or the emulated run's (``checkpoint.load_gathered_checkpoint``:
each rank cuts its blocks; such a file holds one copy of a leaf whole
over ``model``, so the resume follows the reference's resumed run), and
refuses both at once.  ``checkpoint.stitch_rank_checkpoints`` joins a
run's rank files into the gathered file.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --data-shards 2 --model-shards 2 \
        --dist-backend gloo --compression lgc_rar --smoke --device cpu ...
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (load_checkpoint, load_grid_checkpoint,
                                    save_checkpoint, save_rank_checkpoint)
from repro_torch.checkpoint.checkpoint import NODE_LEAVES
from repro_torch.configs import get_arch
from repro_torch.configs.base import (CompressionConfig, ModelConfig,
                                      TrainConfig)
from repro_torch.core.phases import phase_for_step
from repro_torch.core.rate import rate_report
from repro_torch.data import synthetic_token_batches
from repro_torch.dist import chaos
from repro_torch.kernels import LAUNCHES
from repro_torch.dist.sharding import gather_tree, param_pspecs
from repro_torch.launch.mesh import (dp_axes_of, init_process_mesh,
                                     under_torchrun)
from repro_torch.launch.steps import (held_bytes, make_auto_train_step,
                                      make_lgc_train_step, train_state_specs)
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
    p.add_argument("--model-shards", type=int, default=1,
                   help="tensor parallelism over this many processes a "
                        "node (under torchrun only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default="",
                   help="checkpoint .npz to resume from: restores the full "
                        "train state, EF residuals included, fast-forwards "
                        "the data stream and continues at the saved step, "
                        "bit for bit as an uninterrupted run (under "
                        "torchrun each process reads its own "
                        "<name>.rank<r>.npz beside it, or, when there is "
                        "none, cuts its blocks from the gathered file)")
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


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: token ids as int64, the encoder
    embeddings as they are (f32)."""
    out = {}
    for k, x in batch.items():
        t = torch.from_numpy(x).to(device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def _state_tree(cc: CompressionConfig, params, opt_state, comp_state,
                lead: Tuple[int, ...]):
    """What a checkpoint holds: the full train state, without the
    compressor's for ``none`` (the reference's dense trainer has none),
    u and v as ``lead + (n,)``: (K, 1) for the emulated (K, n) stacks,
    the reference's (dp, mp, n); (1, 1) for a rank's (n,) row, its block
    of that."""
    tree = {"params": params, "opt_state": opt_state}
    if cc.method != "none":
        tree["comp_state"] = {
            k: x.reshape(lead + x.shape[-1:]) if k in NODE_LEAVES else x
            for k, x in comp_state.items()}
    return tree


def _save(path: str, tree, step: int, grid, specs) -> None:
    """The emulated run's one file, or under a process grid this rank's
    own (``checkpoint.save_rank_checkpoint``)."""
    if grid is None:
        save_checkpoint(path, tree, step)
    else:
        save_rank_checkpoint(path, tree, step, grid.pm.Ks, grid.pm.node,
                             grid.spec.axis_sizes["model"], grid.pm.shard,
                             specs)


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
    trained parameters, "resumed": {path, step, layout, seconds} or
    None, "report": this process's ``--report`` record or None}.  Under
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
        if args.model_shards > 1:
            raise ValueError(
                f"--model-shards {args.model_shards} needs one process a "
                f"shard: launch it under torchrun (python -m "
                f"torch.distributed.run --nproc-per-node "
                f"{K * args.model_shards} ...)")
        return _run(cfg, args, cc, tc, Ks, K, None,
                    resolve_device(args.device), on_step)
    grid = init_process_mesh(Ks, args.dist_backend, args.device,
                             args.dist_init, model=args.model_shards)
    try:
        return _run(cfg, args, cc, tc, Ks, K, grid, grid.device, on_step)
    finally:
        dist.destroy_process_group()


class _Auto:
    """The auto step in the trainer's loop: no compressor state, no
    wire."""

    def __init__(self, model, tc, grid):
        self.ats = make_auto_train_step(model, tc, grid)
        self.specs = self.ats.pspecs

    def init(self, gen):
        params, opt_state = self.ats.init(gen)
        return params, opt_state, {}

    def step(self, params, opt_state, comp_state, batch, step, phase):
        params, opt_state, metrics = self.ats.step(params, opt_state, batch,
                                                   step)
        return params, opt_state, comp_state, dict(metrics, wire={})


def _run(cfg, args, cc, tc, Ks, K, grid, device, on_step):
    mesh = None if grid is None else grid.pm
    rank0 = grid is None or grid.rank == 0
    model = build_model(cfg)
    auto = grid is not None and cc.method == "none"
    sharded = auto or args.model_shards > 1
    lts = _Auto(model, tc, grid) if auto else \
        make_lgc_train_step(model, tc, K, device, Ks, mesh, grid)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, opt_state, comp_state = lts.init(gen)
    # the checkpoint's u, v: the emulated (K, n) as the reference's (K, 1,
    # n), a rank's (n,) as its (1, 1, n) block; each key's spec on a grid
    lead = (K, 1) if grid is None else (1, 1)
    specs = None if grid is None else train_state_specs(
        lts.specs or param_pspecs(params),
        _state_tree(cc, params, opt_state, comp_state, lead),
        dp_axes_of(grid.spec))
    layout = None if auto else lts.compressor.layout
    if rank0:
        log.info("arch=%s params=%s device=%s nodes=%d mesh=%s%s%s",
                 cfg.name, "auto step" if auto else f"{layout.n_total:,}",
                 device, K, Ks, "" if args.model_shards == 1 else
                 f" x model {args.model_shards}",
                 "" if mesh is None else
                 f" one per process ({mesh.backend})")
    start, resumed = 0, None
    if args.resume:
        # the fresh state is the template: shapes, dtypes and the device
        t0 = time.perf_counter()
        template = _state_tree(cc, params, opt_state, comp_state, lead)
        if grid is None:
            (loaded, start), kind = load_checkpoint(args.resume,
                                                    template), "gathered"
        else:
            loaded, start, kind = load_grid_checkpoint(
                args.resume, template, grid, specs)
        del template
        params, opt_state = loaded["params"], loaded["opt_state"]
        if "comp_state" in loaded:
            comp_state = {k: x.reshape(comp_state[k].shape)
                          if k in NODE_LEAVES else x
                          for k, x in loaded["comp_state"].items()}
        del loaded
        resumed = {"path": args.resume, "step": start, "layout": kind,
                   "seconds": time.perf_counter() - t0}
        log.info("resumed the full train state from %s (%s) at step %d",
                 args.resume, kind, start)
    report = None if auto else rate_report(cc, layout, K)
    if rank0 and not auto:
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
        phase = "dense" if auto else phase_for_step(step, cc)
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
        if phase not in wire and not auto:
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
            _save(ckpt, _state_tree(cc, params, opt_state, comp_state,
                                    lead), step + 1, grid, specs)
            rec["checkpoint_s"] = time.perf_counter() - t0
        if on_step is not None:
            on_step(rec)
    if args.checkpoint_dir:
        _save(ckpt, _state_tree(cc, params, opt_state, comp_state, lead),
              args.steps, grid, specs)
    if args.metrics_out and rank0:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    held = {"params": held_bytes(params), "optimizer": held_bytes(opt_state),
            "compressor": held_bytes(comp_state)}
    full = params
    if sharded and args.report:
        # the whole params on every process, for the digest
        full = gather_tree(params, lts.specs, grid.groups())
    record = None
    if args.report:
        # sharded, each rank's own blocks of the whole state too: a model
        # shard's copy of a leaf whole over ``model`` is its own
        state = _state_tree(cc, params, opt_state, comp_state, lead) \
            if sharded else None
        record = _report(args, grid, device, history, wire, sent, full,
                         comp_state, resumed, held, state)
    return {"history": history, "wire": wire, "rate": report,
            "compressor": None if auto else lts.compressor,
            "params": params, "full_params": full, "opt_state": opt_state,
            "comp_state": comp_state, "held": held, "resumed": resumed,
            "report": record}


def _report(args, grid, device, history, wire, sent, params, comp_state,
            resumed, held, state=None):
    """This process's record, written to ``args.report``/rank<r>.json:
    with ``state``, the digest of this rank's own train state (params
    and optimizer blocks, u, v, AE) beside that of the whole params and
    AE."""
    rank = 0 if grid is None else grid.rank
    digest, leaves = tree_digest({"params": params, **{
        k: comp_state[k] for k in ("ae", "ae_mom") if k in comp_state}})
    state_digest, state_leaves = tree_digest(state) if state is not None \
        else (None, None)
    record = {
        "rank": rank, "mesh": None if grid is None else list(grid.pm.Ks),
        "model_shards": args.model_shards,
        "history": history, "wire": wire, "sent": sent or None,
        "digest": digest, "leaf_digests": leaves,
        "state_digest": state_digest, "state_leaf_digests": state_leaves,
        "held": held,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30
        if device.type == "cuda" else None,
        "launches": dict(LAUNCHES), "resumed": resumed}
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
