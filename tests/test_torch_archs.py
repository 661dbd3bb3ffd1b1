"""The four archs the port's attention decoder runs besides llama3.2-1b
(qwen2-1.5b, granite-8b, phi3-medium-14b, musicgen-medium) against the
JAX reference: their published geometry and every config field, the
registry and the input shapes; and at each one's ``reduced()`` config
(f32) with the reference's weights carried across (qwen2's QKV biases
drawn non-zero), the loss and every gradient leaf, prefill's logits and
cache, and 3 decode steps."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.data import synthetic_token_batches as ref_batches
from repro.models.model import Model as RefModel
from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs
from repro_torch.models.model import build_model
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_unflatten)

ARCHS = ["qwen2-1.5b", "granite-8b", "phi3-medium-14b", "musicgen-medium"]
# port against reference, f32: sums in another order (measured on the
# CPU: the loss within 2.3e-7 relative, each gradient leaf within 2.2e-6
# of its largest entry)
REL = 1e-5


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=REL * scale, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_published_geometry(arch):
    """The numbers of tests/test_archs_smoke.py::
    test_exact_assigned_geometry, and every field the port's config has
    equal to the reference's (name, family, source, rope, bias, tying)."""
    cfg = get_arch(arch)
    expect = {
        "phi3-medium-14b": (40, 5120, 40, 10, 17920, 100352),
        "musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
        "granite-8b": (36, 4096, 32, 8, 14336, 49152),
        "qwen2-1.5b": (28, 1536, 12, 2, 8960, 151936),
    }[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == expect
    ref = ref_get_arch(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    for f in dataclasses.fields(cfg.reduced()):
        assert getattr(cfg.reduced(), f.name) == \
            getattr(ref.reduced(), f.name), f.name
    assert cfg.block_pattern == ("attn",)
    if arch == "qwen2-1.5b":
        assert cfg.qkv_bias and cfg.tie_embeddings
    if arch == "musicgen-medium":
        assert cfg.family == "audio" and cfg.n_heads == cfg.n_kv_heads


def test_registry_and_input_shapes():
    assert set(list_archs()) == set(ARCHS) | {"llama3.2-1b"}
    assert list_archs() == sorted(list_archs())
    assert INPUT_SHAPES.keys() == REF_SHAPES.keys()
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            REF_SHAPES[name])


@functools.lru_cache(maxsize=1)
def _setup(arch):
    rmodel = RefModel(ref_get_arch(arch).reduced())
    rparams = jax.tree_util.tree_map(np.asarray,
                                     rmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    rparams = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if jax.tree_util.keystr(path).endswith("['b']") else x, rparams)
    return rmodel, rparams, build_model(get_arch(arch).reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_prefill_decode_match_reference(arch):
    rmodel, rparams, model = _setup(arch)
    tree = params_from_numpy(rparams)
    if arch == "qwen2-1.5b":
        biases = [x for p, x in tree_leaves_with_path(tree) if p[-1] == "b"]
        assert len(biases) == 3 and all(b.abs().max() > 0 for b in biases)
    # the loss and every gradient leaf
    batch = next(ref_batches(512, 2, 32, seed=3))
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tree)]
    loss, metrics = model.loss(tree_unflatten(tree, leaves),
                               {k: torch.from_numpy(v).long()
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(rparams, batch)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=REL)
    assert float(metrics["tokens"]) == float(rmetrics["tokens"])
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    rleaves = jax.tree_util.tree_leaves(rgrads)
    assert len(rleaves) == len(grads)
    for path, a, b in zip(paths, grads, rleaves):
        _close(a.numpy(), b, str(path))
    # prefill of 24 tokens into a 27-slot cache, then 3 decode steps
    B, S, G = 2, 24, 3
    toks = np.random.default_rng(1).integers(0, 512, (B, S + G)).astype(
        np.int32)
    rlogits, rcache = jax.jit(lambda p, t: rmodel.prefill(
        p, {"tokens": t}, cache_len=S + G))(rparams, toks[:, :S])
    with torch.no_grad():
        logits, cache = model.prefill(
            tree, {"tokens": torch.from_numpy(toks[:, :S]).long()},
            cache_len=S + G)
    _close(logits.numpy(), rlogits, "prefill logits")
    rdecode = jax.jit(rmodel.decode_step)
    for pos in range(S, S + G):
        rlogits, rcache = rdecode(rparams, rcache, toks[:, pos:pos + 1], pos)
        with torch.no_grad():
            logits, cache = model.decode_step(
                tree, cache, torch.from_numpy(toks[:, pos:pos + 1]).long(),
                pos)
        _close(logits.numpy(), rlogits, f"decode at {pos}")
    for key in ("k", "v"):
        _close(cache["p0"][key].numpy(), rcache["p0"][key], f"cache {key}")
    np.testing.assert_array_equal(cache["p0"]["pos"].numpy(),
                                  rcache["p0"]["pos"])
