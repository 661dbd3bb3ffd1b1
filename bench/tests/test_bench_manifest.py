"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""
import json
import re

import pytest
from conftest import BENCH, ROOT

from lgcbench import check, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
B = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in B["workloads"]]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(B) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(B["workloads"]) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16
    assert 1 <= len(B["per_layer"]) <= 128
    assert 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits in its budget
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert all(_line(w) for w in B["command"]) and len(B["command"]) <= 32
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    names = [e["name"] for e in B[kind]]
    assert len(names) == len(set(names))
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[kind]
    for e in B[kind]:
        assert set(e) <= allowed, set(e) - allowed
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if kind == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if kind == "configs":
            assert len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0 < e["bound"] <= 0.25
        if kind == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert e["moves"] in {m["name"] for m in B["end_to_end"]}
            assert set(e.get("workloads", [])) <= set(CELLS)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}
    for cell in CELLS:
        e2e = {m["name"] for m in manifest.metrics_of(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = manifest.metrics_of(cell, "per_layer")
        assert layers
        # a per-layer metric's cells report the metric it moves
        for m in layers:
            assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = manifest.workload(cell)
    cfg = manifest.config(w["config"])
    traffic = manifest.traffic(w["traffic"])
    limits = manifest.limits(cell)
    assert set(limits) == set(check.NUMBERS)
    assert traffic["phase"] in ("warmup", "topk_ae", "compressed")
    assert (BENCH / "lgcref" / f"{cfg['family']}.py").exists()
    assert (BENCH / "lgcbench" / "families" / f"{cfg['family']}.py").exists()
    for kind in ("end_to_end", "per_layer"):
        for m in manifest.metrics_of(cell, kind):
            assert callable(manifest.reader(m["name"]).read)


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert used == {c["name"] for c in B["configs"]}
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in body.get("published", {}), k
