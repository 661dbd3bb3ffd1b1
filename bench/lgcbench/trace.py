"""The device trace of a window: ``torch.profiler`` over the CPU and the
card, reduced to what the result line carries: the seconds in which an
operation ran on the device (the union of the device events' intervals:
kernels, copies and fills; the benchmark's own span annotations left
out), the traced
window's length, the device operations that took most time, and the
longest idle gaps, each labelled by the benchmark's span the host was in
(``bench/<name>``) and the operation that ended the gap."""
from __future__ import annotations

from typing import Dict, List, Tuple

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def start():
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _intervals(prof):
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("bench/"):
            # a span's range appears on the host and, as an annotation,
            # on the device's timeline: only the host's is kept
            if e.device_type != DeviceType.CUDA:
                host.append((tr.start, tr.end, e.name[len("bench/"):]))
        elif e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            dev.append((tr.start, tr.end, e.name))
    return sorted(dev), host


def _span_at(host, t) -> str:
    """The innermost benchmark span holding host time t (us)."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "between steps"


def summary(prof, window_s: float, top: int = 10) -> Dict:
    """{"busy_s", "window_s", "device_ops": [[name, s]], "idle_gaps":
    [[label, s]]}; busy_s is None where the trace holds no device
    event."""
    dev, host = _intervals(prof)
    busy, end = 0.0, None
    by_name: Dict[str, float] = {}
    gaps: List[Tuple[float, float, str]] = []
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        if end is None or a >= end:
            if end is not None and a > end:
                gaps.append((a - end, end, name))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy / 1e6 if dev else None,
        "window_s": window_s,
        "device_ops": [[name[:120], s] for name, s in ops],
        "idle_gaps": [[f"{_span_at(host, t0)}: before {name[:80]}", g / 1e6]
                      for g, t0, name in gaps[:top]],
    }
