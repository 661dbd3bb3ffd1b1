"""The port's training entry point on the CPU (train.main at llama3.2-1b's
smoke config, K = 2 nodes): lgc_rar, sparse_gd and dgc on the mesh wire
and on the packed ring, through their phases, finite losses."""
import numpy as np
import pytest

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_train_common import ARGS
from repro_torch.launch import train


def test_main_runs_end_to_end_on_cpu():
    history = train.main(ARGS + ["--device", "cpu"])
    assert [h["phase"] for h in history] == ["warmup", "topk_ae",
                                             "compressed"]
    assert all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.parametrize("flags", [["--compression", "dgc",
                                    "--topk-backend", "pallas"],
                                   ["--compression", "sparse_gd",
                                    "--topk-backend", "fused"]])
def test_sparse_methods_run_end_to_end_on_cpu(flags):
    history = train.main(ARGS + flags + ["--device", "cpu"])
    assert [h["phase"] for h in history] == ["warmup", "topk_ae", "topk_ae"]
    assert all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.parametrize("flags", [["--compression", "dgc",
                                    "--topk-backend", "pallas"],
                                   ["--compression", "sparse_gd",
                                    "--topk-backend", "fused"],
                                   []])
def test_ring_packed_runs_end_to_end_on_cpu(flags):
    """The packed wire from the entry point: dgc and sparse_gd ship their
    packed top-k pairs, lgc_rar (ARGS) its packed support; each phase's
    byte rows are the ring_packed pricer's."""
    history = train.main(ARGS + flags + ["--transport", "ring_packed",
                                         "--device", "cpu"])
    assert all(np.isfinite(h["loss"]) for h in history)
    assert len(history) == 3
