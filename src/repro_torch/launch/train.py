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
or ``ring_packed``), and logs what the reference trainer logs: the
per-phase loss, the rate report, and per phase the wire bytes each node
moves, per exchange op.  ``--pod-shards`` P > 1 makes the dp mesh (P,
``--data-shards``), K = P x data-shards nodes, the two levels of
``ring_hier``; ``--wire-buckets`` B > 1 buckets the ring exchanges.
Runs on the card unless ``--device cpu``; with no card it raises.  Flags
follow ``repro.launch.train``; the values not ported yet raise
NotImplementedError naming their ROADMAP.md item: ``--transport
chaos:<base>`` and ``--guard`` other than ``off`` (Queue 1 item 2,
chaos, guards and resume).
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import (CompressionConfig, ModelConfig,
                                      TrainConfig)
from repro_torch.core.phases import phase_for_step
from repro_torch.core.rate import rate_report
from repro_torch.data import synthetic_token_batches
from repro_torch.launch.steps import make_lgc_train_step
from repro_torch.models.model import build_model
from repro_torch.utils import resolve_device

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
                   help="the emulated wire between the nodes (all run on "
                        "one device): mesh = the lax collectives, ring = "
                        "the chunked ring, ring_q8 = the ring with an int8 "
                        "q8 reduction (lgc_rar_q8's encoding), ring_hier = "
                        "the intra-/inter-pod rings (with --pod-shards), "
                        "ring_packed = the ring with the packed sparse "
                        "payloads")
    p.add_argument("--wire-buckets", type=int, default=1,
                   help="buckets per ring exchange (1 = unbucketed)")
    p.add_argument("--guard", default="off",
                   choices=["off", "scrub", "skip_round", "fail_fast"],
                   help="exchange guard policy (only off is ported)")
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
                   help="emulated data-parallel nodes per pod")
    p.add_argument("--pod-shards", type=int, default=1,
                   help="pods: the dp mesh becomes (pod x data), K = pod "
                        "x data nodes, the two levels of ring_hier")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--metrics-out", default="")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def run(cfg: ModelConfig, args,
        on_step: Optional[Callable[[int], None]] = None) -> Dict[str, Any]:
    """Train ``cfg`` as ``args`` says; returns {"history": per-step
    records (step, phase, loss, ms), "wire": {phase: {op: {kind: bytes}}},
    "rate": the RateReport, "compressor": the GradientCompressor,
    "params": the trained parameters}.
    ``on_step(step)`` runs after each step has finished on the device
    (a profiler's step marker)."""
    device = resolve_device(args.device)
    # the reference is f32 where it says f32; on the card f32 matmuls and
    # cuDNN convolutions would otherwise be allowed TF32 (cuDNN's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cc = CompressionConfig(method=args.compression, sparsity=args.sparsity,
                           warmup_steps=args.warmup_steps,
                           ae_train_steps=args.ae_train_steps,
                           transport=args.transport,
                           wire_buckets=args.wire_buckets,
                           guard=args.guard,
                           topk_backend=args.topk_backend,
                           ae_backend=args.ae_backend,
                           extract_backend=args.extract_backend)
    tc = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr,
                     steps=args.steps, seed=args.seed, compression=cc)
    model = build_model(cfg)
    Ks = (args.pod_shards, args.data_shards) if args.pod_shards > 1 \
        else (args.data_shards,)
    K = args.pod_shards * args.data_shards
    lts = make_lgc_train_step(model, tc, K, device, Ks)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, opt_state, comp_state = lts.init(gen)
    layout = lts.compressor.layout
    log.info("arch=%s params=%s device=%s nodes=%d mesh=%s", cfg.name,
             f"{layout.n_total:,}", device, K, Ks)
    report = rate_report(cc, layout, K)
    log.info("compression=%s CR(avg)=%.1fx bytes/node=%.0f", cc.method,
             report.compression_ratio, report.bytes_per_node)

    data = synthetic_token_batches(cfg.vocab_size, args.batch, args.seq,
                                   seed=args.seed)
    history, wire = [], {}
    for step in range(args.steps):
        phase = phase_for_step(step, cc)
        batch = {k: torch.from_numpy(x).to(device).long()
                 for k, x in next(data).items()}
        t0 = time.perf_counter()
        params, opt_state, comp_state, metrics = lts.step(
            params, opt_state, comp_state, batch, step, phase)
        loss = float(metrics["loss"])            # waits for the device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        history.append({"step": step, "phase": phase, "loss": loss,
                        "ms": ms})
        if on_step is not None:
            on_step(step)
        if phase not in wire:
            wire[phase] = metrics["wire"]
            log.info("phase=%s wire bytes/node/step by op: %s", phase,
                     {op: {k: int(b) for k, b in row.items()}
                      for op, row in metrics["wire"].items()})
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %4d  phase=%-10s loss=%.4f  %.1f ms", step,
                     phase, loss, ms)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    return {"history": history, "wire": wire, "rate": report,
            "compressor": lts.compressor, "params": params}


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
