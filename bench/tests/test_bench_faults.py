"""``correct`` of whole runs on the CPU at tiny sizes: true for the
program as it is, false with the timed path broken underneath (each
fault a training cell can have), and false for the control, the
reference in float8 put in the program's place."""
import sys
import time

import pytest
from conftest import BENCH, SMALL_TRAFFIC, TINY

from lgcbench import check, manifest
from lgcbench.harness import load_cell, reference_readings
from lgcbench.runner import run
from lgcref import common

sys.path.insert(0, str(BENCH / "checks"))
import faults  # noqa: E402

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]
SEED = 4_294_967_311


def _small(cell):
    fam = manifest.config(manifest.workload(cell)["config"])["family"]
    return TINY[fam], dict(SMALL_TRAFFIC, setup_steps=3)


@pytest.mark.parametrize("fault", [None] + sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_correct_only_when_sound(cell, fault):
    cfg, traffic = _small(cell)
    r = run(cell, SEED, 0.0, False, "cpu", time.time(), cfg, traffic,
            patch=faults.FAULTS.get(fault))
    assert r["correct"] is (fault is None), r["compared"]
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg, traffic = _small(cell)
    c = load_cell(cell, cfg, traffic)
    ref = reference_readings(c, SEED, "cpu")
    control = reference_readings(c, SEED, "cpu", mm=common.fp8_mm)
    ok, compared = check.verdict(check.readings(control, ref), c.limits)
    assert not ok, compared
