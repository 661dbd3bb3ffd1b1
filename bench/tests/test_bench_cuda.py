"""On the card: each cell end to end through the command, a short
window, its result line as the contract reads it.  Skips without a GPU;
on the chip: ``python -m pytest -m cuda bench/tests``."""
import json
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from lgcbench import manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cuda_device, cell, trace):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", "4294967311", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["failed"] == 0, r["compared"]
    assert list(r)[-1] == "compared"
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in manifest.metrics_of(cell, kind)}
    assert set(r["metrics"]) <= want
    if trace:
        assert r["device"]["busy_s"] > 0
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    else:
        assert set(r["metrics"]) == want
