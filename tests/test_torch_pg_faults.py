"""The trainer's failure behaviour one node per process: the chaos wire,
the guard policies and full-state checkpoints with resume, through
``repro_torch.launch.train``'s entry point in gloo ranks
(tests/_torch_pg.py) at ``reduced()`` widths, each launch held on every
rank against the emulated run of the same flags in this process (which
tests/test_torch_chaos.py and tests/test_torch_resume.py hold to the
reference):

- (a) K = 4, dgc on ``chaos:ring_packed --guard scrub --guard-checksum``
  with bit flips, NaNs and an inf on ``topk`` and node 2's contribution
  dropped, 5 steps with a checkpoint every 2, stopped after step 2 on
  every rank (through ``run()``'s ``on_step``): each step's loss and guard record (guard_ok, fault,
  faults, fault_ops) are the twin's, and the 4 rank files stitched
  (``checkpoint.stitch_rank_checkpoints``: u, v's (1, 1, n) blocks into
  the (K, 1, n) arrays, the rest node 0's) are the twin's file of step 3
  key by key.
  The twin is one uninterrupted emulated 5-step run of the same flags:
  a shorter run is another run, its cosine schedule spanning its own
  steps;
- (b) resumed from (a)'s files: steps 3 and 4 (their guard records and
  per-op rows) and the final digest those of the uninterrupted twin;
- (c) K = 2, lgc_rar_q8 on ``chaos:ring_q8 --guard skip_round`` with a
  NaN on the encoding, saved at its end: every compressed round skipped,
  as in the twin;
- a torn save, one of (c)'s two rank files at another step: every rank
  raises CheckpointError naming the files; and (c)'s rank files with
  the gathered file stitched from them beside them: every rank refuses
  the two layouts at once;
- (d) K = 2, lgc_rar on ``chaos:mesh --guard fail_fast``: every rank
  raises the twin's WireFaultError, at the same step;
- the rank files' consistency check itself, in-process: a torn save, a
  missing or foreign file, another mesh, another node's file; and on a
  (data 2, model 2) grid a missing model-shard-1 file, a file of another
  grid and a torn save.

Two launches run them all (tests/_torch_pg_faults_worker.py: the runs
one after another in the same processes): (a) then (b) at K = 4; (c),
the torn save, the two layouts at once and (d) at K = 2.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_pg import launch, worker
from repro_torch.checkpoint import (CheckpointError, check_rank_headers,
                                    rank_path, save_checkpoint,
                                    save_rank_checkpoint,
                                    stitch_rank_checkpoints)
from repro_torch.checkpoint.checkpoint import read_rank_header
from repro_torch.configs import get_arch
from repro_torch.dist import chaos as CH
from repro_torch.launch import train

BASE = ["--smoke", "--batch", "4", "--seq", "16", "--warmup-steps", "1",
        "--ae-train-steps", "1", "--log-every", "1", "--device", "cpu"]
GUARDED = BASE + [
    "--data-shards", "4", "--compression", "dgc", "--topk-backend",
    "pallas", "--transport", "chaos:ring_packed", "--guard", "scrub",
    "--guard-checksum", "--fault-seed", "3", "--fault-bitflips", "2",
    "--fault-nans", "2", "--fault-infs", "1", "--fault-ops", "topk",
    "--fault-drop-node", "2"]
LGC = ["--data-shards", "2", "--topk-backend", "fused", "--ae-backend",
       "pallas", "--fault-nans", "1", "--fault-ops", "encoding"]
SKIP = BASE + LGC + ["--compression", "lgc_rar_q8", "--transport",
                     "chaos:ring_q8", "--guard", "skip_round", "--steps", "3"]
FAIL = BASE + LGC + ["--compression", "lgc_rar", "--transport",
                     "chaos:mesh", "--guard", "fail_fast", "--steps", "3"]
# what a step's record must hold equal to the twin's (not its ms)
KEEP = ("step", "phase", "loss", "guard_ok", "fault", "faults", "fault_ops")
NODE_KEYS = {"comp_state/u", "comp_state/v"}
META = {"__step__", "__mesh__", "__node__", "__model__", "__specs__"}


DIST = ["--dist-backend", "gloo", "--dist-init", "{store}"]


def _chain(tmp, specs, K):
    """Run ``specs`` (tests/_torch_pg_faults_worker.py's plan) as one
    launch of K ranks."""
    with open(tmp / "plan.json", "w") as f:
        json.dump(specs, f)
    launch(tmp, worker("_torch_pg_faults_worker.py") + [
        str(tmp / "plan.json"), "{store}"], K, timeout=180)


def _records(tmp, name, K):
    out = []
    for r in range(K):
        with open(tmp / name / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def _emulated(flags):
    return train.run(get_arch("llama3.2-1b").reduced(),
                     train.parse_args(flags))


def _steps(history, keep=KEEP):
    return [{k: h[k] for k in keep if k in h} for h in history]


def _hold(ranks, emu, first=0):
    """Every rank's steps (from ``first`` on), per-op rows and final
    digest bitwise the twin's."""
    want = _steps(emu["history"][first:])
    phases = {h["phase"] for h in want}
    for r, rec in enumerate(ranks):
        assert _steps(rec["history"]) == want, (r, rec["history"], want)
        assert rec["wire"] == {p: emu["wire"][p] for p in phases}, r
        assert rec["digest"] == emu["report"]["digest"], r


@pytest.fixture(scope="module")
def guarded(tmp_path_factory):
    """(a): the K = 4 run stopped after step 2, then (b) resumed from its
    rank files in the same launch; and the uninterrupted emulated twin,
    whose file of step 3 is kept as ckpt3.npz."""
    tmp = tmp_path_factory.mktemp("pg_guarded")
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks' one thread
    flags = GUARDED + ["--steps", "5", "--checkpoint-every", "2"]
    emu_ckpt = tmp / "emu_ckpt"

    def keep(rec):
        if rec["step"] == 2:
            shutil.copyfile(emu_ckpt / "ckpt.npz", emu_ckpt / "ckpt3.npz")
    try:
        _chain(tmp, [
            {"argv": flags + ["--checkpoint-dir", str(tmp / "ckpt")] + DIST,
             "stop_after": 2, "out": str(tmp / "ranks")},
            {"argv": GUARDED + [
                "--steps", "5", "--resume", str(tmp / "ckpt" / "ckpt.npz"),
                "--report", str(tmp / "resumed")] + DIST}], 4)
        emu = train.run(get_arch("llama3.2-1b").reduced(), train.parse_args(
            flags + ["--checkpoint-dir", str(emu_ckpt), "--report",
                     str(tmp / "emu")]), on_step=keep)
    finally:
        torch.set_num_threads(n)
    return tmp, emu


def test_guarded_chaos_run_and_its_rank_files_match_emulated(guarded):
    tmp, emu = guarded
    want = _steps(emu["history"][:3])
    for r, rec in enumerate(_records(tmp, "ranks", 4)):
        assert _steps(rec["history"]) == want, (r, rec["history"], want)
    sparsified = [h for h in emu["history"] if h["phase"] != "warmup"]
    assert sparsified and all(
        h["guard_ok"] == 0 and h["fault_ops"]["topk"] == {
            "bitflip": 2, "nan": 2, "inf": 1, "drop": 1}
        for h in sparsified), sparsified
    # the rank files stitched: each node's (1, 1, n) block of u, v into
    # the emulated (K, 1, n), the replicated rest node 0's alone
    ckpt = str(tmp / "ckpt" / "ckpt.npz")
    files = [dict(np.load(rank_path(ckpt, r))) for r in range(4)]
    for r, f in enumerate(files):
        assert f["__mesh__"].tolist() == [4] and int(f["__node__"]) == r
        assert int(f["__step__"]) == 3 and f["__model__"].tolist() == [1, 0]
        if r:
            assert set(f) == NODE_KEYS | META, (r, sorted(f))
    stitch_rank_checkpoints(ckpt, str(tmp / "stitched.npz"))
    with np.load(tmp / "stitched.npz") as z:
        stitched = {k: z[k] for k in z.files}
    with np.load(tmp / "emu_ckpt" / "ckpt3.npz") as z:
        want = {k: z[k] for k in z.files}
    assert set(stitched) == set(want)
    for key, a in want.items():
        b = stitched[key]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), key
        assert a.tobytes() == b.tobytes(), key


def test_resumed_process_run_matches_uninterrupted(guarded):
    """(b): the data stream fast-forwarded, the same seeded faults, the
    running fault total restarted as an emulated resume restarts it."""
    tmp, emu = guarded
    ranks = _records(tmp, "resumed", 4)
    keep = tuple(k for k in KEEP if k != "faults")
    for r, rec in enumerate(ranks):
        assert rec["resumed"]["step"] == 3, r
        assert [h["step"] for h in rec["history"]] == [3, 4], r
        assert _steps(rec["history"], keep) == _steps(
            emu["history"][3:], keep), r
        assert [h["faults"] for h in rec["history"]] == list(np.cumsum(
            [sum(h["fault"].values()) for h in rec["history"]])), r
        assert rec["wire"] == {"topk_ae": emu["wire"]["topk_ae"]}, r
        assert rec["digest"] == emu["report"]["digest"], r


@pytest.fixture(scope="module")
def skipped(tmp_path_factory):
    """The K = 2 launch: (c) saved at its end; rank 1's file of it torn
    (marked as saved at step 5) and resumed from, which must raise
    CheckpointError; (c)'s files beside the gathered file stitched from
    them, which must raise CheckpointError; (d), which must raise
    WireFaultError.  And (c)'s emulated twin."""
    tmp = tmp_path_factory.mktemp("pg_skip")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _chain(tmp, [
            {"argv": SKIP + ["--checkpoint-dir", str(tmp / "ckpt"),
                             "--report", str(tmp / "ranks")] + DIST},
            {"tear": str(tmp / "ckpt" / "ckpt.npz"),
             "into": str(tmp / "torn"), "rank": 1, "step": 5},
            {"argv": SKIP + ["--resume", str(tmp / "torn" / "ckpt.npz")]
             + DIST, "expect": "CheckpointError",
             "out": str(tmp / "torn_report")},
            {"stitch": str(tmp / "ckpt" / "ckpt.npz")},
            {"argv": SKIP + ["--resume", str(tmp / "ckpt" / "ckpt.npz")]
             + DIST, "expect": "CheckpointError",
             "out": str(tmp / "both_report")},
            {"argv": FAIL + DIST, "expect": "WireFaultError",
             "out": str(tmp / "fail")}], 2)
        emu = _emulated(SKIP + ["--report", str(tmp / "emu")])
    finally:
        torch.set_num_threads(n)
    return tmp, emu


def test_skip_round_process_run_matches_emulated(skipped):
    """(c): the compressed round has a NaN on its encoding, so it is
    skipped on every rank, as node 0 of the twin skips it."""
    tmp, emu = skipped
    _hold(_records(tmp, "ranks", 2), emu)
    comp = [h for h in emu["history"] if h["phase"] == "compressed"]
    assert comp and all(h["guard_ok"] == 0 and h["fault_ops"] == {
        "encoding": {"nan": 1}} for h in comp), comp


def test_torn_save_is_refused_on_every_rank(skipped):
    """Rank 1's file from a later save than rank 0's: every rank raises
    the same CheckpointError, naming the files, and none hangs."""
    tmp, _ = skipped
    errors = {rec["error"] for rec in _records(tmp, "torn_report", 2)}
    assert len(errors) == 1, errors
    error = errors.pop()
    assert "torn save" in error and "ckpt.rank1.npz at 5" in error \
        and "ckpt.rank0.npz at 3" in error, error


def test_rank_files_beside_a_gathered_file_are_refused(skipped):
    """Rank files and a gathered file at one path: every rank raises the
    same CheckpointError naming both, and none falls back to either."""
    tmp, _ = skipped
    errors = {rec["error"] for rec in _records(tmp, "both_report", 2)}
    assert len(errors) == 1, errors
    error = errors.pop()
    ckpt = str(tmp / "ckpt" / "ckpt.npz")
    assert error.startswith("CheckpointError: both the gathered checkpoint")
    assert all(f in error for f in (ckpt, rank_path(ckpt, 0),
                                    rank_path(ckpt, 1))), error


def test_fail_fast_raises_on_every_rank_at_one_step(skipped):
    """(d): the first compressed step's NaN on the encoding: every rank
    raises the twin's WireFaultError (node 0's counts, the same step and
    op on each), no rank left in a collective, and the processes go on
    to their next run."""
    tmp, _ = skipped
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(CH.WireFaultError) as ei:
            _emulated(FAIL)
    finally:
        torch.set_num_threads(n)
    want = f"WireFaultError: {ei.value}"
    assert "at step 2" in want and "encoding" in want, want
    assert [rec["error"] for rec in _records(tmp, "fail", 2)] == [want,
                                                                  want]


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g).bfloat16()},
            "opt_state": {"m": {"w": torch.randn(3, 4, generator=g)}},
            "comp_state": {"u": torch.randn(6, generator=g),
                           "v": torch.randn(6, generator=g),
                           "ae": {"b": torch.randn(2, generator=g)}}}


def _broken(case, path):
    """Break node 1's file of ``path`` (two nodes) as ``case`` says; on
    the (data 2, model 2) grid (``grid_*``) rank 1's, node 0's model
    shard 1, or rank 3's."""
    if case == "grid_missing":
        os.remove(rank_path(path, 1))
    elif case == "grid_other":
        save_rank_checkpoint(path, _state(1), 7, (4,), 1)
    elif case == "grid_torn":
        save_rank_checkpoint(path, _state(3), 8, (2,), 1, 2, 1)
    elif case == "torn":
        save_rank_checkpoint(path, _state(1), 9, (2,), 1)
    elif case == "missing":
        os.remove(rank_path(path, 1))
    elif case == "mesh":
        save_rank_checkpoint(path, _state(1), 7, (1, 2), 1)
    elif case == "node":
        shutil.copyfile(rank_path(path, 0), rank_path(path, 1))
    elif case == "foreign":
        save_checkpoint(rank_path(path, 1), _state(1), 7)


@pytest.mark.parametrize("case", ["whole", "torn", "missing", "mesh", "node",
                                  "foreign", "grid_missing", "grid_other",
                                  "grid_torn"])
def test_rank_file_check(tmp_path, case):
    path = str(tmp_path / "ckpt.npz")
    model = 2 if case.startswith("grid") else 1
    for rank in range(2 * model):
        save_rank_checkpoint(path, _state(rank), 7, (2,), rank // model,
                             model, rank % model)
    _broken(case, path)
    headers = [read_rank_header(path, r) for r in range(2 * model)]
    if model == 2:
        with pytest.raises(CheckpointError) as ei:
            check_rank_headers(headers, (2,), 2)
        msg = str(ei.value)
        want = {"grid_missing": "ckpt.rank1.npz: missing",
                "grid_other": "ckpt.rank1.npz: saved on the mesh (4,), not "
                              "(2,) x model 2",
                "grid_torn": "ckpt.rank3.npz at 8"}[case]
        assert want in msg, msg
        assert case != "grid_torn" or "torn save" in msg, msg
        return
    if case == "whole":
        assert check_rank_headers(headers, (2,)) == 7
        with np.load(rank_path(path, 1)) as z:
            assert set(z.files) == NODE_KEYS | META
        with np.load(rank_path(path, 0)) as z:
            # bf16 as the 2-byte void entry, as save_checkpoint writes it
            assert z["params/w"].dtype == np.dtype("V2")
        return
    with pytest.raises(CheckpointError, match="ckpt.rank1.npz") as ei:
        check_rank_headers(headers, (2,))
    msg = str(ei.value)
    assert {"torn": "torn save", "missing": "missing", "mesh": "(1, 2)",
            "node": "node 0's, not node 1's",
            "foreign": "not a rank file"}[case] in msg, msg
