"""Where a training step's device time goes: the trainer under
``torch.profiler``, one trace per step.

    PYTHONPATH=src python -m repro_torch.launch.profile --layers 4 \\
        --compression lgc_rar --topk-backend fused --ae-backend pallas \\
        --data-shards 2 --batch 8 --seq 128 --warmup-steps 2 \\
        --ae-train-steps 2 --steps 6

Takes ``repro_torch.launch.train``'s flags plus ``--layers`` (cut the
arch's depth), so ``--compression dgc --topk-backend pallas``,
``--compression sparse_gd --topk-backend fused`` or ``--transport
ring_packed`` (the packed wire's kernels) trace those paths.
Every step after the first runs under its own profiler window, opened
and closed between steps.  Prints one JSON line per traced
step: its wall ms (host clock, synchronised, profiler on), the device's
busy ms (the sum of the kernels' own times; one stream, so kernels do not
overlap), the idle share, and the kernels by total device time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.launch import train


def kernel_times(prof):
    """[(kernel name, device ms, launches)] by device time, kernels only
    (an operator's own device time is its kernels' and is not counted
    twice)."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def main(argv=None):
    logging.basicConfig(level=logging.WARNING)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--top", type=int, default=12)
    own, rest = p.parse_known_args(argv)
    args = train.parse_args(rest)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if own.layers:
        cfg = dataclasses.replace(cfg, n_layers=own.layers)
    acts = [ProfilerActivity.CPU]
    if args.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    traces = {}
    live = []

    def on_step(rec):
        step = rec["step"]
        if live:
            live[0].stop()
            traces[step] = kernel_times(live.pop())
        if step + 1 < args.steps:
            live.append(profile(activities=acts))
            live[0].start()

    out = train.run(cfg, args, on_step=on_step)
    for h in out["history"]:
        if h["step"] not in traces:
            continue
        kernels = traces[h["step"]]
        # a CPU rehearsal has no device numbers to give
        busy = sum(ms for _, ms, _ in kernels) if len(acts) > 1 else None
        print(json.dumps({
            "arch": cfg.name, "n_layers": cfg.n_layers, "device": args.device,
            "step": h["step"], "phase": h["phase"], "wall_ms": h["ms"],
            "device_busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / h["ms"],
            "kernels": len(kernels),
            "top": [{"kernel": k[:120], "ms": ms, "calls": c}
                    for k, ms, c in kernels[:own.top]]}), flush=True)


if __name__ == "__main__":
    main()
