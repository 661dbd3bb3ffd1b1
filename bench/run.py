#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port's LGC training: one run of
one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU.  The
cell's configuration, traffic, limits and metrics are found by name from
``BENCHMARK.json``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (spans and the device trace).  The
last line of standard output is the result as one JSON object; the
numbers compared against the reference, each with its limit, are the
last lines of standard error.  Exits non-zero, with no result, without
a GPU or with fewer than the cell asks for, and if JAX or the JAX
package was loaded."""
import time

T0 = time.time()                                  # the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from lgcbench import manifest
    from lgcbench.runner import run

    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
