"""Spans recorded from the benchmark's side: a wrapped call on the
step object the benchmark built gets a CUDA event before and after it
(device time, read once the window is over) and, while the profiler
runs, a ``record_function`` range of the same name, which labels the
trace's idle gaps."""
from __future__ import annotations

import functools
from typing import Dict, List

import torch


class Spans:
    def __init__(self, device):
        self.device = torch.device(device)
        self.marks: Dict[str, List] = {}
        self.live = False           # recording (the window) or not

    def wrap(self, root, attr_path: str, name: str) -> bool:
        """Wrap ``root.<attr_path>`` (dotted) in span ``name``; False
        where the attribute does not exist."""
        *parents, attr = attr_path.split(".")
        obj = root
        for p in parents:
            obj = getattr(obj, p, None)
            if obj is None:
                return False
        fn = getattr(obj, attr, None)
        if not callable(fn):
            return False
        self.marks.setdefault(name, [])
        cuda = self.device.type == "cuda"

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not self.live:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(f"bench/{name}"):
                if cuda:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = fn(*args, **kwargs)
                    b.record()
                    self.marks[name].append((a, b))
                else:
                    out = fn(*args, **kwargs)
                return out
        # a frozen dataclass (the compressor, the optimizer) refuses
        # setattr; the instance attribute shadows the method either way
        object.__setattr__(obj, attr, spanned)
        return True

    def ms(self) -> Dict[str, List[float]]:
        """{span: [device ms of each call]}; no entry for a span that was
        never wrapped, an empty list where no call was timed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {name: [a.elapsed_time(b) for a, b in marks]
                for name, marks in self.marks.items()}
