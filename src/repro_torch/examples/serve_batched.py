"""Serve a small model with batched requests: prefill a batch of prompts,
then decode tokens in lockstep from the cache (counterpart of the
reference's ``examples/serve_batched.py``), at the arch's smoke config,
sampling at temperature 0.8.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--arch mamba2-130m] [--device cpu]

Runs on the card unless ``--device cpu``; with no card it raises.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", default="mamba2-130m",
                        help="any ported arch (its smoke variant is used)")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--prompt-len", type=int, default=48)
    parser.add_argument("--gen", type=int, default=24)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    gen = serve.main(["--arch", args.arch, "--smoke",
                      "--batch", str(args.batch),
                      "--prompt-len", str(args.prompt_len),
                      "--gen", str(args.gen),
                      "--temperature", "0.8", "--device", args.device])
    print(f"generated {gen.shape[0]} x {gen.shape[1]} tokens")
    return gen


if __name__ == "__main__":
    main()
