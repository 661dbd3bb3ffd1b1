"""The trainer under a process group: ``repro_torch.launch.train``'s
entry point in K = 4 processes (tests/_torch_pg_train_worker.py, one
gloo rank a node), six lgc_rar steps (2 warm-up, 2 top-k + AE, 2
compressed) on ``ring_hier`` over a (2, 2) pod mesh at ``reduced()``,
batch 8, seq 16, from the reference's initial weights and AE:

- bitwise the emulated run of the same flags in this process
  (``LGCTrainStep`` with the K nodes stacked): every step's loss, each
  phase's per-op rows on every rank, and the final params and AE (their
  digest, equal on every rank);
- and so the reference's own 4-device trainer: that emulated twin
  (``_torch_train_common.hier_twin``) is, in
  tests/test_torch_train_wire.py, bit for bit ``hier_loop`` from the
  same weights, the loop held there to the reference's trainer
  (REF_HIER) within the trajectory tests' bounds (losses to 1e-5, rows
  exactly, params to 2e-5 of their largest value), whose initial weights
  and AE are ``reference_hier_init``'s, the ones these runs start from.

And what a launch refuses: a world size other than pod x data shards,
and no ``--dist-backend`` under torchrun (or one without it).  The
chaos wire, the guards and checkpoint/resume under torchrun are
tests/test_torch_pg_faults.py's."""
import json

import numpy as np
import pytest

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_pg import launch, worker
from _torch_train_common import (HIER_FLAGS, HIER_K, hier_twin,
                                 reference_hier_init)
from repro_torch.configs import get_arch
from repro_torch.launch import train

K, FLAGS = HIER_K, HIER_FLAGS


def test_process_trainer_matches_emulated_and_reference(tmp_path,
                                                        monkeypatch):
    """Every rank's losses, rows and digest are the emulated twin's
    (``hier_twin``, whose chain to the reference's trainer is
    tests/test_torch_train_wire.py's)."""
    np.savez(tmp_path / "init.npz", **reference_hier_init())
    launch(tmp_path, worker("_torch_pg_train_worker.py") + [
        str(tmp_path / "init.npz")] + FLAGS + [
        "--dist-backend", "gloo", "--dist-init", "{store}", "--report",
        str(tmp_path / "ranks")], K, timeout=120)
    emu = hier_twin(str(tmp_path / "init.npz"), monkeypatch,
                    ["--report", str(tmp_path / "emu")])
    losses = [h["loss"] for h in emu["history"]]
    for r in range(K):
        with open(tmp_path / "ranks" / f"rank{r}.json") as f:
            rec = json.load(f)
        assert [h["loss"] for h in rec["history"]] == losses, r
        assert rec["wire"] == emu["wire"], r
        assert rec["digest"] == emu["report"]["digest"], r
        # each rank sent its share: the pod ring's and the data ring's
        assert set(rec["sent"]) == set(emu["wire"]), r


def _torchrun_env(monkeypatch, world):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", str(world))


def _args(*extra):
    return train.parse_args(FLAGS + ["--steps", "1", *extra])


def test_world_size_must_hold_the_mesh(monkeypatch):
    _torchrun_env(monkeypatch, 3)
    with pytest.raises(ValueError, match="WORLD_SIZE=3"):
        train.run(get_arch("llama3.2-1b").reduced(),
                  _args("--dist-backend", "gloo"))


def test_backend_is_chosen_not_defaulted(monkeypatch):
    cfg = get_arch("llama3.2-1b").reduced()
    with pytest.raises(ValueError, match="torchrun"):
        train.run(cfg, _args("--dist-backend", "gloo"))
    _torchrun_env(monkeypatch, K)
    with pytest.raises(ValueError, match="--dist-backend"):
        train.run(cfg, _args())
