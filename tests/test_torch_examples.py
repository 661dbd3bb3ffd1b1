"""The port's text-file stream, its two examples and its rate functions
against the reference, on the CPU:

- ``text_file_token_batches`` on ``PAPER.md`` bitwise the reference's
  stream, and its refusal of a file too small for one window;
- ``examples/quickstart.py``'s ``main`` at each ``--topk-backend``: its
  layout, plan and rate lines as the reference's own ``GradientLayout``,
  ``fused_plan_info`` and ``rate_report`` give them (formatted as the
  reference's example formats them), and its ten step lines the same on
  all three backends (the stand-in gradients are the port's own draws,
  so the errors are not the reference's);
- ``train_lgc_vs_baselines`` at 12 smoke steps: the five methods reach
  the top-k + AE phase with finite losses;
- ``wire_payload_terms`` and ``total_information_tb`` equal the
  reference's."""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

from _one_thread import one_thread  # noqa: F401  (autouse)
from repro.configs.base import CompressionConfig as RCC
from repro.core import build_compressor as ref_build_compressor
from repro.core import rate as RR
from repro.core import sparsify as RSP
from repro.data import text_file_token_batches as ref_text
from repro_torch.configs.base import CompressionConfig
from repro_torch.core import rate as R
from repro_torch.core.compressors import build_compressor
from repro_torch.data import text_file_token_batches
from repro_torch.examples import quickstart as Q
from repro_torch.examples import train_lgc_vs_baselines as B

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAPER = os.path.join(REPO, "PAPER.md")
BACKENDS = ("jnp", "pallas", "fused")
TRANSPORTS = (("ring", None), ("ring_q8", None), ("ring_hier", (2, 2)),
              ("ring_packed", None))


@pytest.mark.parametrize("seed", (0, 3))
def test_text_stream_is_the_references(seed):
    ours = text_file_token_batches(PAPER, 4, 64, seed=seed)
    ref = ref_text(PAPER, 4, 64, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        assert a["tokens"].shape == (4, 64)
        assert a["tokens"].max() < 256


def test_text_stream_refuses_a_file_too_small():
    n = os.path.getsize(PAPER)
    with pytest.raises(ValueError, match="file too small"):
        text_file_token_batches(PAPER, 2, n - 1)
    with pytest.raises(AssertionError, match="file too small"):
        next(ref_text(PAPER, 2, n - 1))
    # one byte more than a window is enough for both
    assert next(text_file_token_batches(PAPER, 2, n - 2))["tokens"].shape \
        == next(ref_text(PAPER, 2, n - 2))["tokens"].shape == (2, n - 2)


def _reference_lines(backend, extract="auto"):
    """The reference quickstart's first three lines, from its functions
    on the same tree."""
    params = {"embed": {"w": jnp.zeros((64, 32))},
              "hidden": {"w": jnp.zeros((512, 512))},
              "lm_head": {"w": jnp.zeros((32, 64))}}
    cc = RCC(method="lgc_rar", sparsity=0.01, warmup_steps=2,
             ae_train_steps=5, topk_backend=backend, extract_backend=extract)
    layout = ref_build_compressor(cc, params, Q.K).layout
    info = RSP.fused_plan_info(layout, extract=extract)
    report = RR.rate_report(cc, layout, Q.K)
    return {
        "layout": f"gradient vector n={layout.n_total}, top-k "
                  f"mu={layout.mu}, AE input mu_pad={layout.mu_pad}",
        "plan": f"fused sweep plan: block={info['fused_block']} "
                f"n_cand={info['n_cand']} extract={info['extract_backend']}"
                + ("" if backend == "fused" else "  [not active: "
                   f"--topk-backend {backend}]"),
        "rate": f"rate: {report.bytes_per_node:.0f} B/node/step "
                f"(baseline {report.baseline_bytes:.0f} B) -> "
                f"CR {report.compression_ratio:.0f}x"}


def test_quickstart_matches_reference_on_every_backend(capsys):
    steps = {}
    for backend in BACKENDS:
        out = Q.main(["--topk-backend", backend, "--device", "cpu"])
        for key, line in _reference_lines(backend).items():
            assert out[key] == line, (backend, key)
        steps[backend] = out["steps"]
        assert len(out["steps"]) == Q.STEPS
        assert out["tree"] == (
            "reconstructed gradient tree: {'embed': {'w': (64, 32)}, "
            "'hidden': {'w': (512, 512)}, 'lm_head': {'w': (32, 64)}}")
    assert steps["pallas"] == steps["fused"] == steps["jnp"]
    assert [s.split()[2] for s in steps["jnp"]] == \
        ["phase=warmup"] * 2 + ["phase=topk_ae"] * 5 + \
        ["phase=compressed"] * 3
    # the other block rule of the fused sweep's plan
    out = Q.main(["--topk-backend", "fused", "--extract-backend", "bitonic",
                  "--device", "cpu"])
    assert out["plan"] == _reference_lines("fused", "bitonic")["plan"]
    assert out["steps"] == steps["jnp"]
    printed = capsys.readouterr().out.splitlines()
    assert printed[:3] == [out_line for out_line in
                           _reference_lines("jnp").values()]


def test_baselines_reach_the_ae_phase_with_finite_losses(monkeypatch):
    histories = {}
    train_main = B.train_main

    def spy(argv):
        hist = train_main(argv)
        histories[argv[argv.index("--compression") + 1]] = hist
        return hist
    monkeypatch.setattr(B, "train_main", spy)
    losses = B.main(["--smoke", "--steps", "12", "--device", "cpu"])
    assert list(losses) == list(B.METHODS)
    assert all(math.isfinite(v) for v in losses.values()), losses
    for method, hist in histories.items():
        assert len(hist) == 12 and hist[-1]["loss"] == losses[method]
        want = "warmup" if method == "none" else "topk_ae"
        assert hist[-1]["phase"] == want, method


def test_wire_payload_terms_and_information_match_reference():
    import torch
    shapes = {"embed": (64, 32), "hidden": (512, 512), "lm_head": (32, 64)}
    ours_p = {k: {"w": torch.zeros(s)} for k, s in shapes.items()}
    ref_p = {k: {"w": jnp.zeros(s)} for k, s in shapes.items()}
    for method in ("none", "sparse_gd", "dgc", "lgc_ps", "lgc_rar",
                   "lgc_rar_q8"):
        cc = CompressionConfig(method=method, sparsity=0.01)
        rcc = RCC(method=method, sparsity=0.01)
        layout = build_compressor(cc, ours_p, Q.K).layout
        rlayout = ref_build_compressor(rcc, ref_p, Q.K).layout
        for transport, axes in TRANSPORTS:
            ours = R.wire_payload_terms(cc, layout, Q.K, transport, axes)
            ref = RR.wire_payload_terms(rcc, rlayout, Q.K, transport, axes)
            assert ours == ref and ours, (method, transport)
        # the default mesh shape is one axis of K
        assert R.wire_payload_terms(cc, layout, Q.K, "ring") == \
            R.wire_payload_terms(cc, layout, Q.K, "ring", (Q.K,))
    for args in ((12500.0, 4, 1000), (1064960, 16, 30000), (0.5, 1, 1)):
        assert R.total_information_tb(*args) == \
            RR.total_information_tb(*args)
