"""The port's serving path against the JAX reference on the llama3.2-1b
smoke config (f32) with the reference's weights carried across: prefill's
logits and cache, greedy decode steps from the cache, decode-from-cache
against a full prefill, the sliding-window ring cache, and the serve
entry point on the CPU (its greedy tokens equal to the reference's
prefill + decode loop on the same prompt and weights)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.utils.convert import params_from_numpy

# port against reference, f32: measured on the CPU <= 1.5e-6 of the
# largest logit and <= 5.2e-6 absolute on the cache's k, v (|k| ~ 4)
REL = 1e-5


def _close(a, b, rel, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


@functools.lru_cache(maxsize=2)
def _setup(window=0):
    kw = {"sliding_window": window} if window else {}
    rmodel = RefModel(ref_get_arch("llama3.2-1b").reduced(**kw))
    rparams = jax.tree_util.tree_map(np.asarray,
                                     rmodel.init(jax.random.PRNGKey(0)))
    model = build_model(get_arch("llama3.2-1b").reduced(**kw))
    return rmodel, rparams, model, params_from_numpy(rparams)


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _t(x):
    return torch.from_numpy(x).long()


@pytest.mark.parametrize("window", [0, 16])
def test_prefill_and_decode_match_reference(window):
    """Prefill of 40 tokens into a 45-slot cache (a 16-slot ring under a
    window), then 5 decode steps: the logits to 1e-5 of their largest
    entry, the cache's k, v to 1e-5 of theirs and its positions equal,
    after prefill and after the last step."""
    rmodel, rparams, model, params = _setup(window)
    B, S, G = 2, 40, 5
    toks = _tokens(B, S + G)
    rlogits, rcache = jax.jit(lambda p, t: rmodel.prefill(
        p, {"tokens": t}, cache_len=S + G))(rparams, toks[:, :S])
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": _t(toks[:, :S])},
                                      cache_len=S + G)
    assert tuple(logits.shape) == (B, 1, 512) and logits.dtype == \
        torch.float32
    _close(logits.numpy(), rlogits, REL, "prefill logits")

    def same_cache(where):
        assert cache.keys() == rcache.keys() == {"p0"}
        for key in ("k", "v", "pos"):
            ours, ref = cache["p0"][key].numpy(), np.asarray(rcache["p0"][key])
            assert ours.shape == ref.shape and ours.dtype == ref.dtype, key
            if key == "pos":
                np.testing.assert_array_equal(ours, ref, where)
            else:
                _close(ours, ref, REL, f"{where} {key}")
    same_cache("prefill")
    rdecode = jax.jit(rmodel.decode_step)
    for i in range(G):
        pos = S + i
        rlogits, rcache = rdecode(rparams, rcache, toks[:, pos:pos + 1], pos)
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache,
                                              _t(toks[:, pos:pos + 1]), pos)
        _close(logits.numpy(), rlogits, REL, f"decode at {pos}")
    same_cache("after decode")


@pytest.mark.parametrize("window,seq_len", [(0, 40), (16, 40), (16, 8)])
def test_init_cache_matches_reference(window, seq_len):
    """init_cache: the reference's tree, shapes and dtypes (seq_len
    slots, the window's under a sliding window), zero k, v and int32-max
    positions."""
    rmodel, _, model, _ = _setup(window)
    ours, ref = model.init_cache(3, seq_len), rmodel.init_cache(3, seq_len)
    assert ours.keys() == ref.keys() == {"p0"}
    for key in ("k", "v", "pos"):
        a, b = ours["p0"][key].numpy(), np.asarray(ref["p0"][key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, key)


@pytest.mark.parametrize("window,S", [(0, 32), (16, 48), (16, 12)])
def test_decode_from_cache_equals_full_prefill(window, S):
    """The pattern of the reference's test_decode_matches_prefill (and,
    windowed, test_sliding_window_decode_ring_buffer): prefill S - 4
    tokens into an S-slot cache, decode the last 4; each step's logits
    equal the full prefill's last-token logits of the same prefix to
    1e-5 of their largest entry (measured on the CPU: 0 without a window,
    <= 1e-6 with one).  Windowed, the cache is a ring of 16 slots, and a
    12-token prompt fills only part of it."""
    _, _, model, params = _setup(window)
    toks = _tokens(2, S, seed=S)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": _t(toks[:, :S - 4])},
                                 cache_len=S)
        assert cache["p0"]["k"].shape[2] == (min(S, window) if window
                                             else S)
        for pos in range(S - 4, S):
            logits, cache = model.decode_step(params, cache,
                                              _t(toks[:, pos:pos + 1]), pos)
            full, _ = model.prefill(params, {"tokens": _t(toks[:, :pos + 1])})
            _close(logits.numpy(), full.numpy(), REL, f"position {pos}")


def test_decode_past_the_cache_raises():
    _, _, model, params = _setup()
    toks = _t(_tokens(1, 8))
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, cache_len=8)
        with pytest.raises(IndexError, match="past the cache"):
            model.decode_step(params, cache, toks[:, :1], 8)


def _serve_args(*extra):
    return serve.parse_args(["--smoke", "--batch", "2", "--prompt-len", "24",
                             "--gen", "6", "--device", "cpu", *extra])


def test_serve_greedy_tokens_match_reference():
    """The entry point's run() on the CPU with the reference's weights:
    the same numpy prompt, and greedy tokens equal to the reference's
    prefill + decode loop (its launch/serve.py's) on that prompt."""
    rmodel, rparams, _, params = _setup()
    args = _serve_args()
    out = serve.run(get_arch("llama3.2-1b").reduced(), args, params=params)
    prompt = np.random.default_rng(args.seed).integers(
        0, 512, (2, 24)).astype(np.int32)
    np.testing.assert_array_equal(out["prompt"], prompt)
    logits, cache = jax.jit(lambda p, t: rmodel.prefill(
        p, {"tokens": t}, cache_len=30))(rparams, prompt)
    want = [np.asarray(logits[:, -1].argmax(-1)).astype(np.int32)]
    rdecode = jax.jit(rmodel.decode_step)
    for i in range(5):
        logits, cache = rdecode(rparams, cache, want[-1][:, None], 24 + i)
        want.append(np.asarray(logits[:, 0].argmax(-1)).astype(np.int32))
    np.testing.assert_array_equal(out["tokens"], np.stack(want, 1))
    assert len(out["step_ms"]) == 5 and out["prefill_ms"] > 0


def test_serve_cli_runs_on_cpu():
    gen = serve.main(["--smoke", "--batch", "2", "--prompt-len", "16",
                      "--gen", "4", "--device", "cpu"])
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    assert ((0 <= gen) & (gen < 512)).all()


def test_serve_sampling_is_seeded():
    """--temperature > 0 samples from a torch.Generator seeded by --seed:
    the same seed gives the same tokens, the first token stays prefill's
    argmax."""
    _, _, _, params = _setup()
    cfg = get_arch("llama3.2-1b").reduced()
    greedy = serve.run(cfg, _serve_args(), params=params)["tokens"]
    a, b, c = (serve.run(cfg, _serve_args("--temperature", "1.0", "--seed",
                                          str(s)), params=params)["tokens"]
               for s in (0, 0, 1))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, 0], greedy[:, 0])
    assert ((0 <= c) & (c < 512)).all()


@pytest.mark.parametrize("flag", ["--data-shards", "--model-shards"])
def test_serve_on_several_devices_outside_torchrun_raises(flag):
    """One process a shard: several shards need torchrun (their runs are
    tests/test_torch_tp.py's)."""
    with pytest.raises(ValueError, match="under torchrun"):
        serve.main(["--smoke", flag, "2", "--device", "cpu"])


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--gen", "2"])


def test_serve_batched_example_runs_on_cpu():
    """repro_torch.examples.serve_batched with the reference example's
    defaults (mamba2-130m at its smoke config, batch 4, prompt 48, gen
    24, temperature 0.8): a (4, 24) block of tokens."""
    from repro_torch.examples import serve_batched
    gen = serve_batched.main(["--device", "cpu"])
    assert gen.shape == (4, 24) and gen.dtype == np.int32
    assert ((0 <= gen) & (gen < 512)).all()
