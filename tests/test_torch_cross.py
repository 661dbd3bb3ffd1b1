"""The port's cross-attention (``layers.init_cross_attention``,
``cross_attention_kv``, ``cross_attention_fwd``) against the JAX
reference's at llama-3.2-vision-90b's smoke config (f32: d_model 256, 8
heads, 4 KV heads of 32, encoder width 128), with the reference's
weights carried across and the tanh gate set to 0.5 in both (at its
initial 0 the layer adds nothing and its projections' gradients are 0,
which the last test pins): k, v and the output at S = 24 queries over T
= 16 encoder tokens and over T = 1601 (the published count: the
reference's key chunk halves to 1, the port pads the keys to 2048 and
masks the padding by index); every gradient, the gate's and the
embeddings' included; bf16 weights with f32 embeddings (k and v f32 as
jnp's promotion gives them, the output bf16, the prefill's cross cache
f32); and the embedding stream bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_arch_checks import GATE, set_gates
from repro.configs import get_arch as ref_get_arch
from repro.data import synthetic_token_batches as ref_batches
from repro.models import layers as RL
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.data import synthetic_token_batches
from repro_torch.models import flash
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, \
    tree_unflatten

# port against reference, f32: sums in another order (measured on the
# CPU: <= 1.3e-6 of the largest entry on every output and gradient)
REL = 1e-5
# the bf16 output against the reference's bf16 run: both round f32
# sums to 8 significant bits, so a sum that lands on either side of a
# rounding boundary differs by one bf16 step (2^-8 of a value); held to
# one step of the largest entry (measured on the CPU: equal)
BF16_REL = 2.0 ** -8
ARCH = "llama-3.2-vision-90b"
S = 24


def _close(a, b, what, rel=REL):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


def _setup(dtype="float32", gate=GATE):
    rcfg, cfg = (dataclasses.replace(g(ARCH).reduced(), dtype=dtype)
                 for g in (ref_get_arch, get_arch))
    rp = jax.tree_util.tree_map(np.asarray, RL.init_cross_attention(
        jax.random.PRNGKey(0), rcfg, jnp.dtype(dtype)))
    return rcfg, cfg, set_gates(rp, gate)


def _draw(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_chunk_plan_pads_the_published_encoder_tokens():
    """1601 is prime: the reference's key chunk halves to 1 key; the
    port keeps the 1024-key chunk and pads the keys to 2048."""
    assert flash._chunks(S, 1601) == (S, 1)
    assert flash.chunk_plan(S, 1601) == (S, 1024, S, 2048)
    assert flash.chunk_plan(S, 16) == (S, 16, S, 16)


@pytest.mark.parametrize("T", [16, 1601])
def test_cross_attention_matches_reference(T):
    """k, v (B, T, KH, hd) and the gated output, B = 2, S = 24 != T."""
    rcfg, cfg, rp = _setup()
    x = _draw(2, S, cfg.d_model)
    enc = _draw(2, T, cfg.encoder_dim, seed=1)
    rk, rv = RL.cross_attention_kv(rp, rcfg, enc)
    ry = jax.jit(lambda p, x, k, v: RL.cross_attention_fwd(
        p, rcfg, x, (k, v)))(rp, x, rk, rv)
    tree = params_from_numpy(rp)
    with torch.no_grad():
        k, v = L.cross_attention_kv(tree, cfg, torch.from_numpy(enc))
        y = L.cross_attention_fwd(tree, cfg, torch.from_numpy(x), (k, v))
    assert k.shape == (2, T, cfg.n_kv_heads, cfg.head_dim) == v.shape
    _close(k, rk, "k")
    _close(v, rv, "v")
    _close(y, ry, "y")
    assert float((y - torch.from_numpy(x)).abs().max()) > 0


@pytest.mark.parametrize("T", [16, 1601])
def test_cross_attention_grads_match_reference(T):
    """The gradients of sum(y * r) with respect to x, the embeddings and
    every weight leaf (the gate's too), through kv and the non-causal
    flash backward."""
    rcfg, cfg, rp = _setup()
    x = _draw(2, S, cfg.d_model)
    enc = _draw(2, T, cfg.encoder_dim, seed=1)
    r = _draw(2, S, cfg.d_model, seed=2)

    def ref_obj(p, x, e):
        return (RL.cross_attention_fwd(p, rcfg, x, RL.cross_attention_kv(
            p, rcfg, e)) * r).sum()

    rgrads = jax.jit(jax.grad(ref_obj, argnums=(0, 1, 2)))(rp, x, enc)
    tree = params_from_numpy(rp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    xt, et = (torch.from_numpy(a).requires_grad_(True) for a in (x, enc))
    p = tree_unflatten(tree, leaves)
    y = L.cross_attention_fwd(p, cfg, xt, L.cross_attention_kv(p, cfg, et))
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                leaves + [xt, et])
    paths = [str(q) for q, _ in tree_leaves_with_path(tree)] + ["x", "enc"]
    want = jax.tree_util.tree_leaves(rgrads[0]) + list(rgrads[1:])
    assert len(want) == len(grads) and "('gate',)" in paths
    for path, a, b in zip(paths, grads, want):
        assert float(np.abs(np.asarray(b)).max()) > 0, path
        _close(a, b, "d" + path)


def test_bf16_weights_with_f32_embeddings():
    """bf16 params and f32 embeddings, as the data stream and serving
    give them: k and v come out f32 (jnp promotes bf16 @ f32 to f32;
    PyTorch's @ refuses mixed dtypes, so the port promotes), the output
    bf16, each within BF16_REL of the reference's bf16 run; and the
    prefill's cross cache at reduced(dtype="bfloat16"), cut to one
    superblock, is f32 in both, holding what the prefill computed."""
    rcfg, cfg, rp = _setup("bfloat16")
    x = _draw(2, S, cfg.d_model).astype(jnp.bfloat16)
    enc = _draw(2, 16, cfg.encoder_dim, seed=1)
    rk, rv = RL.cross_attention_kv(rp, rcfg, enc)
    ry = RL.cross_attention_fwd(rp, rcfg, x, (rk, rv))
    assert (rk.dtype, rv.dtype, ry.dtype) == (jnp.float32, jnp.float32,
                                              jnp.bfloat16)
    tree = params_from_numpy(rp)
    assert tree["wk"]["w"].dtype == torch.bfloat16
    with torch.no_grad():
        k, v = L.cross_attention_kv(tree, cfg, torch.from_numpy(enc))
        y = L.cross_attention_fwd(
            tree, cfg, torch.from_numpy(x.astype(np.float32)).bfloat16(),
            (k, v))
    assert (k.dtype, v.dtype, y.dtype) == (torch.float32, torch.float32,
                                           torch.bfloat16)
    _close(k, rk, "k")
    _close(v, rv, "v")
    _close(y, ry, "y", BF16_REL)
    # the model's prefill: the cross cache f32, the other caches bf16
    rmodel = RefModel(dataclasses.replace(rcfg, n_layers=5))
    model = build_model(dataclasses.replace(cfg, n_layers=5))
    rparams = set_gates(jax.tree_util.tree_map(
        np.asarray, jax.jit(rmodel.init)(jax.random.PRNGKey(0))))
    toks = np.random.default_rng(2).integers(0, 512, (2, 8)).astype(np.int32)
    enc = _draw(2, cfg.num_encoder_tokens, cfg.encoder_dim, seed=3)
    _, rcache = jax.jit(lambda p, b: rmodel.prefill(p, b))(
        rparams, {"tokens": toks, "encoder_embeds": enc})
    with torch.no_grad():
        _, cache = model.prefill(params_from_numpy(rparams), {
            "tokens": torch.from_numpy(toks).long(),
            "encoder_embeds": torch.from_numpy(enc)})
    cross = model.cfg.block_pattern.index("cross")
    for pos, c in cache.items():
        for key, t in c.items():
            want = rcache[pos][key]
            assert str(t.dtype).split(".")[-1] == str(want.dtype), (pos, key)
            if pos == f"p{cross}":
                assert t.dtype == torch.float32
                _close(t, want, f"cache {pos} {key}")
    assert model.init_cache(2, 8)[f"p{cross}"]["k"].dtype == torch.float32


def test_zero_gate_adds_nothing():
    """At init (gate 0, tanh(0) = 0) the layer returns x exactly and the
    gradients of wq, wk, wv and wo are exactly 0, in the port as in the
    reference: why every parity check sets the gates non-zero."""
    rcfg, cfg, rp = _setup(gate=0.0)
    x = _draw(2, S, cfg.d_model)
    enc = _draw(2, 16, cfg.encoder_dim, seed=1)
    tree = params_from_numpy(rp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    p = tree_unflatten(tree, leaves)
    y = L.cross_attention_fwd(p, cfg, torch.from_numpy(x),
                              L.cross_attention_kv(p, cfg,
                                                   torch.from_numpy(enc)))
    assert torch.equal(y, torch.from_numpy(x))
    grads = dict(zip((q for q, _ in tree_leaves_with_path(tree)),
                     torch.autograd.grad(y.sum(), leaves)))
    for name in ("wq", "wk", "wv", "wo"):
        assert not grads[(name, "w")].any(), name
    assert grads[("gate",)].abs().max() > 0
    rgrads = jax.jit(jax.grad(lambda p: RL.cross_attention_fwd(
        p, rcfg, x, RL.cross_attention_kv(p, rcfg, enc)).sum()))(rp)
    assert not np.asarray(rgrads["wq"]["w"]).any()


def test_encoder_stream_matches_reference():
    """synthetic_token_batches with encoder_tokens: tokens, labels and
    the f32 embeddings (drawn after the tokens from the step's
    generator) bit for bit the reference's, three steps."""
    ours = synthetic_token_batches(512, 3, 16, seed=5, encoder_tokens=16,
                                   encoder_dim=128)
    ref = ref_batches(512, 3, 16, seed=5, encoder_tokens=16,
                      encoder_dim=128)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys() == {"tokens", "labels",
                                        "encoder_embeds"}
        assert a["encoder_embeds"].dtype == np.float32
        assert a["encoder_embeds"].shape == (3, 16, 128)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
