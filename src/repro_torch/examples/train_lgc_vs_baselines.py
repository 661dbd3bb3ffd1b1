"""Every compressor against the dense baseline (counterpart of the
reference's ``examples/train_lgc_vs_baselines.py``): trains a llama
family model with ``repro_torch.launch.train`` under ``none``,
``sparse_gd``, ``dgc``, ``lgc_rar`` and ``lgc_ps`` at the same flags
(batch 8, seq 128, alpha 0.01, 10 warm-up and 20 AE-training steps, lr
3e-3, K = ``--data-shards`` nodes) and prints each final loss and the
largest degradation against ``none`` (the paper's Fig. 10 / Table VI
experiment, small).

    PYTHONPATH=src python -m repro_torch.examples.train_lgc_vs_baselines \\
        [--steps 120] [--full-1b] [--device cpu]

``--smoke`` (the reduced llama3.2-1b: 2 blocks, d_model 256) is the
default; ``--full-1b`` trains llama3.2-1b itself.  Runs on the card
unless ``--device cpu``; with no card it raises.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict

from repro_torch.launch.train import main as train_main

METHODS = ("none", "sparse_gd", "dgc", "lgc_rar", "lgc_ps")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--data-shards", type=int, default=2)
    p.add_argument("--full-1b", action="store_true",
                   help="train the full llama3.2-1b")
    p.add_argument("--smoke", action="store_true",
                   help="the reduced model (the default without "
                        "--full-1b)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    """Train each method; returns {method: final loss} and prints them
    with the largest degradation against ``none``."""
    args = parse_args(argv)
    results: Dict[str, float] = {}
    for method in METHODS:
        targv = ["--arch", "llama3.2-1b", "--steps", str(args.steps),
                 "--batch", "8", "--seq", "128",
                 "--compression", method, "--sparsity", "0.01",
                 "--warmup-steps", "10", "--ae-train-steps", "20",
                 "--data-shards", str(args.data_shards),
                 "--lr", "3e-3", "--log-every", str(max(args.steps // 10, 1)),
                 "--device", args.device]
        if not args.full_1b:
            targv.append("--smoke")
        print(f"\n===== compression = {method} =====", flush=True)
        hist = train_main(targv)
        results[method] = float(hist[-1]["loss"])

    print("\nfinal losses (convergence parity is the paper's claim):")
    for method, loss in results.items():
        print(f"  {method:10s} {loss:.4f}")
    worst = max(results.values())
    print(f"max degradation vs baseline: {worst - results['none']:+.4f} nats",
          flush=True)
    if not all(math.isfinite(v) for v in results.values()):
        raise FloatingPointError(f"a final loss is not finite: {results}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
