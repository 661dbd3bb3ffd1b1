"""Time the packed wire's kernels (K4 quantize_pack, K5a pack_bits, K5b
unpack_bits) on the card, split into device and host time, for the
``repro_torch`` of a given source tree.

    python tools/bitpack_times.py [--src DIR] [--batched] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's); point it at a ``git archive`` of another commit
unpacked under ``build/`` to compare two versions in one run on one card.
``--batched`` also times K5b on the K = 2 gathered table in one launch
(a tree whose ``unpack_bits`` takes a (B, width, W) stack).  The timing is
``chip_smoke.bitpack_times``: at the path's PackPlan (llama3.2-1b, 4
layers, alpha = 0.001: 243,296 pairs, 16 low bits), ``ms`` (CUDA events
around 200 back-to-back calls), ``device_ms`` (the same calls in one CUDA
graph) and ``host_us`` (1000 calls, no synchronise).  ``--host-parts``
also times the pieces of the K4 and K5b wrappers' host work one by one
(``host_us``; this checkout's wrappers), and beside the wrappers' a
one-element ``fill_``: the host time and the device time (``device_ms``,
in a CUDA graph) of the smallest PyTorch launch.
Prints one JSON line with the label, the card's name and power limit.
Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_parts(dev) -> dict:
    """host_us of each piece of the K4 / K5b wrappers at the path's
    shapes, and device_ms where a piece launches."""
    import torch

    import chip_smoke as cs
    from repro_torch.dist import quantize as Q
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import bitpack as BP
    k, width, sb = 243296, 16, 256
    W, m = BP.word_count(k), -(-k // sb)
    gen = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randn(k, generator=gen, device=dev)
    lo = torch.randint(0, 1 << width, (k,), generator=gen, device=dev,
                       dtype=torch.int32)
    words = BP.pack_bits(lo, width)
    stream = BP._stream(dev)
    out = torch.empty((k,), dtype=torch.int32, device=dev)
    qp = BP.quantize_pack(vals, lo, width, sb, Q._EPS)
    ptrs = [t.data_ptr() for t in (vals, lo) + qp]
    unpack, quantize_pack = BP._entry("unpack_bits"), BP._entry(
        "quantize_pack")
    tiny = torch.zeros((1,), device=dev)
    nw = width * W
    pieces = {
        "unpack_bits (wrapper)": lambda: BP.unpack_bits(words, k),
        "unpack_bits C entry alone": lambda: unpack(
            words.data_ptr(), out.data_ptr(), 1, k, width, W, stream),
        "quantize_pack (wrapper)": lambda: BP.quantize_pack(
            vals, lo, width, sb, Q._EPS),
        "quantize_pack C entry alone": lambda: quantize_pack(
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], k, width, W, m, sb,
            Q._EPS, stream),
        "current_stream(dev).cuda_stream": lambda:
            torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream(index)": lambda: BP._stream(dev),
        "one torch.empty": lambda: torch.empty((k,), dtype=torch.int32,
                                               device=dev),
        "K4 outputs: one empty + views": lambda: (
            lambda buf: (buf.as_strided((width, W), (W, 1)),
                         buf.view(torch.float32).as_strided((m,), (1,), nw),
                         buf.view(torch.int8).as_strided(
                             (m, sb), (sb, 1), 4 * (nw + m))))(
            torch.empty((nw + m + m * sb // 4,), dtype=torch.int32,
                        device=dev)),
        "K4 outputs: three empties": lambda: (
            torch.empty((width, W), dtype=torch.int32, device=dev),
            torch.empty((m, sb), dtype=torch.int8, device=dev),
            torch.empty((m,), dtype=torch.float32, device=dev)),
        "K4 checks": lambda: BP._check("quantize_pack", vals, lo),
        "LAUNCHES += 1": lambda: LAUNCHES.update(("x",)),
        "fill_ of one element": lambda: tiny.fill_(0.0),
    }
    # the C entries alone launch on the stream taken before the capture,
    # so only their host time is measured
    launches = {"unpack_bits (wrapper)", "quantize_pack (wrapper)",
                "fill_ of one element"}
    return {name: {"host_us": cs.host_us(fn, 1000),
                   **({"device_ms": cs.graph_ms(fn, 200)}
                      if name in launches else {})}
            for name, fn in pieces.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", default=os.path.join(ROOT, "src"))
    p.add_argument("--batched", action="store_true")
    p.add_argument("--host-parts", action="store_true")
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke               # puts this checkout's src on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch
    if not torch.cuda.is_available():
        sys.exit("bitpack_times: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    times = chip_smoke.bitpack_times(dev, args.batched)
    if args.host_parts:
        times["host_parts"] = host_parts(dev)
    print(json.dumps({"label": args.label, "card": smi,
                      "repro_torch": os.path.dirname(repro_torch.__file__),
                      **times}), flush=True)


if __name__ == "__main__":
    main()
