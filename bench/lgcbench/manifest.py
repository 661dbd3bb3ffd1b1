"""Everything of a cell, found by name: the ``BENCHMARK.json`` entry,
its configuration's file, its traffic mix (``traffic/<name>.json``),
its limits (``checks/limits/<workload>.json``) and each metric's reader
(``metrics/<metric>.py``)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]          # the bench/ folder
ROOT = BENCH.parent


def _read(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return _read(root / "BENCHMARK.json")


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(name: str, root: Path = ROOT) -> Dict:
    return _named(benchmark(root)["workloads"], name, "workload")


def config(name: str, root: Path = ROOT) -> Dict:
    entry = _named(benchmark(root)["configs"], name, "config")
    return _read(root / entry["file"])


def traffic(name: str) -> Dict:
    return _read(BENCH / "traffic" / f"{name}.json")


def limits(workload_name: str) -> Dict:
    return _read(BENCH / "checks" / "limits" / f"{workload_name}.json")


def metrics_of(workload_name: str, kind: str, root: Path = ROOT
               ) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    with no ``workloads`` key and those that list it."""
    return [m for m in benchmark(root)[kind]
            if workload_name in m.get("workloads", [workload_name])]


def reader(metric_name: str):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
