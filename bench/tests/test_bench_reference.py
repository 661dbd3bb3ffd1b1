"""The reference against the program on the CPU, at the program's
``reduced()`` widths in float32: one step of each phase, the same
weights and batches on both sides, the loss, the weights, the error
feedback and the autoencoder after each step."""
import json

import pytest
import torch
from conftest import BENCH, SMALL, SMALL_TRAFFIC

from lgcbench import weights
from lgcbench.harness import Program, batches, load_cell
from lgcref import lgc

SEED = 3_000_000_019


def _pair(cell_name, config=None, **traffic):
    """The cell at SMALL sizes; ``config`` names another configuration
    file to run under the cell's traffic."""
    cfg = load_cell(cell_name).cfg
    if config is not None:
        cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    train = dict(cfg["train"], total_steps=5)        # no lr warm-up
    cell = load_cell(cell_name, dict(cfg, **SMALL[cfg["family"]],
                                     train=train),
                     dict(SMALL_TRAFFIC, first_step=0, **traffic))
    prog = Program(cell, SEED, "cpu")
    ref = lgc.Reference(cell.family, cell.cfg, train, cell.comp(), cell.K,
                        "cpu")
    ae = weights.draw_ae(SEED, "cpu") \
        if cell.traffic["method"].startswith("lgc") else None
    ref.init(weights.draw(cell.spec, SEED, "cpu"), ae)
    return cell, prog, ref


def _close(a, b, scale, tol):
    return float(torch.linalg.vector_norm(a.float() - b.float())) \
        <= tol * max(float(scale), 1e-12)


def _compare(cell, prog, ref, steps):
    bs = batches(cell, SEED, "cpu", len(steps))
    w0 = weights.draw(cell.spec, SEED, "cpu")
    for j, phase in enumerate(steps):
        assert cell.phase(j) == phase
        loss = prog.step()[0]
        ref_loss = ref.step(bs[j]["tokens"], bs[j]["labels"], j, phase)
        assert loss == pytest.approx(ref_loss, rel=1e-5), phase
        p = weights.flatten(prog.params)
        # compressed: where rounding moves one entry of the support, the
        # autoencoder's input shifts from there on (mamba2: 5e-3)
        tol = 2e-2 if phase == "compressed" else 1e-3
        for path, w in ref.params.items():
            moved = torch.linalg.vector_norm(w.float() - w0[path].float())
            assert _close(p[path], w, moved, tol), (phase, path)
        if hasattr(ref, "u_ef"):
            for mine, theirs in ((prog.comp_state["u"], ref.u_ef),
                                 (prog.comp_state["v"], ref.v_ef)):
                # the two SSD scans round apart by ~4e-5, which may move
                # a leaf's k-th entry: one entry cleared on one side only
                assert _close(mine, theirs,
                              torch.linalg.vector_norm(theirs), 1e-2)
        if "ae" in prog.comp_state:
            for path, x in weights.flatten(prog.comp_state["ae"]).items():
                # a bias leaves zero by one SGD step: its gradient sums
                # many terms that cancel, in another order on each side
                assert _close(x, ref.ae[path],
                              torch.linalg.vector_norm(ref.ae[path]), 1e-2)


@pytest.mark.parametrize("config", ["granite-8b-l3", "mamba2-130m"])
def test_lgc_rar_each_phase(config):
    """warm-up, top-k with the autoencoder's training, compressed."""
    c, prog, ref = _pair("granite8b.lgc_rar.compressed", config,
                         warmup_steps=1, ae_train_steps=1)
    _compare(c, prog, ref, ["warmup", "topk_ae", "compressed"])


def test_dgc_on_the_int8_wire():
    """dgc: momentum correction, per-leaf top-k (the block top-k's plain
    version), the int8 packed wire."""
    c, prog, ref = _pair("granite8b.lgc_rar.compressed", method="dgc",
                         topk_backend="pallas", ae_backend="jnp",
                         warmup_steps=0, phase="topk_ae")
    _compare(c, prog, ref, ["topk_ae", "topk_ae"])


def test_dense_baseline():
    c, prog, ref = _pair("granite8b.none.dense")
    _compare(c, prog, ref, ["warmup"])
