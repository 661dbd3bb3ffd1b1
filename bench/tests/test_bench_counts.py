"""The benchmark's own counts against hand arithmetic."""
import json

import pytest
from conftest import BENCH

from lgcbench import counts
from lgcbench.harness import load_cell


def _spec(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return cfg, __import__(f"lgcref.{cfg['family']}",
                           fromlist=["x"]).params_spec(cfg)


def test_granite_weights():
    _, spec = _spec("granite-8b-l3")
    D, F, V, L = 4096, 14336, 49152, 3
    attn = 2 * D * D + 2 * D * 1024 + D          # q, o; k, v; its norm
    mlp = 3 * D * F + D
    assert attn + mlp == 218_112_000
    assert counts.n_params(spec) == L * (attn + mlp) + V * D + D \
        == 855_666_688


def test_mamba2_weights():
    _, spec = _spec("mamba2-130m")
    D, N, H, L, V = 768, 128, 24, 24, 50280
    di = 2 * D
    block = (D                                  # norm
             + D * (2 * di + 2 * N + H)         # in_proj
             + 4 * (di + 2 * N) + (di + 2 * N)  # conv weight, bias
             + 3 * H                            # A_log, dt_bias, D
             + di + di * D)                     # out norm, out_proj
    assert counts.n_params(spec) == L * block + V * D + D == 128_983_488


def test_select_bytes():
    cfg, spec = _spec("granite-8b-l3")
    n_sel = 855_666_688 - 49152 * 4096          # all but the embedding
    # k of every selectable leaf, round(size / 1000)
    sizes = [4096, 3 * 4096, 3 * 4096 * 4096, 3 * 4096 * 1024,
             3 * 4096 * 4096, 3 * 4096 * 1024, 3 * 4096,
             3 * 14336 * 4096, 3 * 4096 * 14336, 3 * 4096 * 14336]
    assert sum(sizes) == n_sel
    k = sum(max(1, round(s / 1000)) for s in sizes)
    assert counts.select_bytes(spec, 0.001) == 20 * n_sel + 8 * k


@pytest.mark.parametrize("cell,tokens", [
    ("granite8b.lgc_rar.compressed", 8192),
    ("granite8b.none.dense", 8192),
])
def test_tokens_per_step(cell, tokens):
    assert load_cell(cell).tokens_per_step == tokens
