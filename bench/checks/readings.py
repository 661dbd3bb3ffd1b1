#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip at the
cell's own size, many seeds in one process:

    python3 bench/checks/readings.py --workload <name> \\
        --seeds 1,2,... [--control-seeds 7,8,9] [--out <file.jsonl>]

For each of ``--seeds``: the program's set-up steps (the run's own set-up:
the same step object, feed and batches) against the float32 reference,
the three compared numbers.  For each of ``--control-seeds``: the
control (the reference with every matmul's operands in float8 e4m3, put
in the program's place) and the reference with each fault planted
(``half_batch``, ``no_exchange``; ``frozen`` reads 1 by construction)
against the float32 reference.  One JSON line per reading."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    from lgcbench import check
    from lgcbench.harness import (free_cuda, load_cell, reference_readings,
                                  setup)
    from lgcref import common

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t0 = time.time()
        prog, mine = setup(cell, seed, args.device)
        del prog
        free_cuda()
        ref = reference_readings(cell, seed, args.device)
        emit({"workload": cell.name, "kind": "program", "seed": seed,
              "readings": check.readings(mine, ref),
              "losses": [mine["losses"], ref["losses"]],
              "seconds": time.time() - t0})
        free_cuda()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        ref = reference_readings(cell, seed, args.device)
        for kind, kw in (("control", {"mm": common.fp8_mm}),
                         ("half_batch", {"fault": "half_batch"}),
                         ("no_exchange", {"fault": "no_exchange"})):
            t0 = time.time()
            other = reference_readings(cell, seed, args.device, **kw)
            emit({"workload": cell.name, "kind": kind, "seed": seed,
                  "readings": check.readings(other, ref),
                  "seconds": time.time() - t0})
            free_cuda()
    return 0


if __name__ == "__main__":
    sys.exit(main())
