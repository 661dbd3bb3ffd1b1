"""A run of a cell, from set-up to the result's line (``run``), and what
the metric readers are handed (``Run``)."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from lgcbench import check, hw, manifest
from lgcbench.harness import (Cell, Window, free_cuda, load_cell,
                              reference_readings, setup, window)


@dataclass
class Run:
    """What a metric's ``read(run)`` may look at."""
    cell: Cell
    window: Window
    setup_s: float
    peak_bytes: Optional[int]
    device_name: str
    power_limit_w: Optional[float]

    @property
    def steps(self) -> int:
        return len(self.window.step_ms)

    @property
    def tokens_per_s(self) -> float:
        return self.steps * self.cell.tokens_per_step / self.window.seconds


def run(name: str, seed: int, seconds: float, traced: bool, device,
        t0: float, cfg_over: Optional[Dict] = None,
        traffic_over: Optional[Dict] = None,
        patch: Optional[Callable] = None) -> Dict:
    """One run of cell ``name``; returns the result's object.  ``t0``:
    the process's start on the host clock (``time.time()``)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cell = load_cell(name, cfg_over, traffic_over)
    defs = manifest.metrics_of(name, "per_layer" if traced else
                               "end_to_end")
    readers = {m["name"]: manifest.reader(m["name"]) for m in defs}
    targets: Dict[str, str] = {}
    for r in readers.values():
        targets.update(getattr(r, "SPANS", {}))
    dev_name = torch.cuda.get_device_name(device) if cuda else "cpu"
    power = hw.power_limit_w() if cuda else None

    t_setup = time.time()
    prog, prog_read = setup(cell, seed, device, patch)
    setup_s = time.time() - t0
    parts = dict(prog.setup_s, before=t_setup - t0,
                 readings=time.time() - t_setup - prog.setup_s["program"]
                 - sum(prog.setup_s["steps"]))
    win = window(prog, seconds, traced, targets)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    del prog
    free_cuda()

    t_ref = time.time()
    ref_read = reference_readings(cell, seed, device)
    ref_s = time.time() - t_ref
    got = check.readings(prog_read, ref_read)
    ok, compared = check.verdict(got, cell.limits)
    failed = sum(not math.isfinite(x) for x in win.losses)

    ctx = Run(cell, win, setup_s, peak, dev_name, power)
    metrics = {}
    for m in defs:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": dev_name,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": ok and failed == 0, "attempted": len(win.step_ms),
              "failed": failed, "metrics": metrics, "device": dev}
    if win.trace is not None:
        dev["busy_s"] = win.trace["busy_s"]
        dev["window_s"] = win.trace["window_s"]
        result["breakdown"] = {"device_ops": win.trace["device_ops"],
                               "idle_gaps": win.trace["idle_gaps"]}
    result["notes"] = {
        "seed": seed, "power_limit_w": power, "window_s": win.seconds,
        "steps": len(win.step_ms), "traced_steps": win.trace_steps,
        "setup_parts_s": parts, "reference_s": ref_s,
        "worst": {k: got[k]["at"] for k in check.NUMBERS},
        "losses": {"program": prog_read["losses"],
                   "reference": ref_read["losses"]}}
    result["compared"] = compared
    return result
