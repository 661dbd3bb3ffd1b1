"""Quickstart: compress the gradients of a toy model with LGC (counterpart
of the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--topk-backend jnp|pallas|fused] [--extract-backend auto|loop|
        bitonic] [--device cpu]

A three-leaf tree (embed (64, 32), hidden (512, 512), lm_head (32, 64):
n = 266,240) at K = 4 emulated nodes, lgc_rar with alpha = 0.01, 2
warm-up and 5 AE-training steps, then compressed steps; it prints the
layout, the fused sweep's plan, the rate, one line per step with the
relative error of the reconstructed mean against the dense mean, and the
reconstructed tree's shapes.  ``--topk-backend fused`` selects with the
one-launch accumulate + select sweep (K1 on the card), ``pallas`` with
the block top-k per leaf (K6), ``jnp`` with the plain selection; every
path selects the same indices in the same order, so the step lines are
the same on all three.

The stand-in gradients (a smooth common part, as real gradients are
locally correlated, plus small per-node innovations), the hidden
weights and the AE's initial weights come from seeded
``torch.Generator``s on the CPU, so a run on the card starts from the
CPU run's values.  They cannot be the reference's ``jax.random``
draws, so the printed errors differ from the reference's; the
compressed steps' depend on the AE's draw.  Runs on the card unless
``--device cpu``; with no card it raises.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict

import torch

from repro_torch.configs.base import CompressionConfig
from repro_torch.core import sparsify as SP
from repro_torch.core.compressors import build_compressor
from repro_torch.core.phases import phase_for_step
from repro_torch.core.rate import rate_report
from repro_torch.utils import (deterministic_convs, disable_tf32,
                               resolve_device)
from repro_torch.utils.tree import tree_map, tree_unflatten_vector

K = 4
STEPS = 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--topk-backend", default="jnp",
                    choices=("jnp", "pallas", "fused"),
                    help="top-k selection path (fused = the single-sweep "
                         "kernel)")
    ap.add_argument("--extract-backend", default="auto",
                    choices=sorted(SP.EXTRACT_BACKENDS),
                    help="the fused sweep's per-block extractor rule, "
                         "which sizes its blocks (only used with "
                         "--topk-backend fused)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    """Run the quickstart; returns its printed lines: "layout", "plan",
    "rate", "steps" (ten lines) and "tree"."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    deterministic_convs()
    gen = torch.Generator().manual_seed(0)
    params = {"embed": {"w": torch.zeros((64, 32))},
              "hidden": {"w": torch.randn((512, 512), generator=gen) * 0.05},
              "lm_head": {"w": torch.zeros((32, 64))}}
    params = tree_map(lambda p: p.to(device), params)

    cc = CompressionConfig(method="lgc_rar", sparsity=0.01, warmup_steps=2,
                           ae_train_steps=5, topk_backend=args.topk_backend,
                           extract_backend=args.extract_backend)
    comp = build_compressor(cc, params, K)
    # drawn on the CPU, as the gradients below: the card starts where the
    # CPU does (a CUDA generator's stream is another)
    states = tree_map(lambda x: x.to(device), comp.init_sim_states(
        torch.Generator().manual_seed(1)))
    lines: Dict = {}

    def say(key, line):
        print(line, flush=True)
        if key == "steps":
            lines.setdefault("steps", []).append(line)
        else:
            lines[key] = line

    layout = comp.layout
    say("layout", f"gradient vector n={layout.n_total}, top-k "
                  f"mu={layout.mu}, AE input mu_pad={layout.mu_pad}")
    info = SP.fused_plan_info(layout, extract=args.extract_backend)
    say("plan", f"fused sweep plan: block={info['fused_block']} "
                f"n_cand={info['n_cand']} extract={info['extract_backend']}"
        + ("" if args.topk_backend == "fused" else "  [not active: "
           f"--topk-backend {args.topk_backend}]"))
    report = rate_report(cc, layout, K)
    say("rate", f"rate: {report.bytes_per_node:.0f} B/node/step "
                f"(baseline {report.baseline_bytes:.0f} B) -> "
                f"CR {report.compression_ratio:.0f}x")

    n = layout.n_total
    t = torch.arange(n, dtype=torch.float32) / n
    base = torch.sin(2 * math.pi * 3 * t) \
        + 0.5 * torch.sin(2 * math.pi * 11 * t)
    draws = torch.Generator().manual_seed(2)
    for step in range(STEPS):
        common = base * (1.0 + 0.1 * torch.randn((), generator=draws)) * 0.01
        g_nodes = (common[None] + 0.0005 * torch.randn(
            (K, n), generator=draws)).to(device)
        phase = phase_for_step(step, cc)
        g_global, states, _ = comp.sim_step(states, g_nodes, step, phase)
        mean = g_nodes.mean(0)
        err = float(torch.linalg.vector_norm(g_global - mean)
                    / torch.linalg.vector_norm(mean))
        say("steps", f"step {step} phase={phase:10s} "
                     f"rel_err_vs_dense_mean={err:.3f}")

    g_tree = tree_unflatten_vector(g_global, params)
    say("tree", "reconstructed gradient tree: "
        f"{tree_map(lambda x: tuple(x.shape), g_tree)}")
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
