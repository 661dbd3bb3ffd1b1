"""The arch parity check shared by tests/test_torch_archs*.py: at an arch's
``reduced()`` config (f32), with the reference's weights carried across
(QKV biases drawn non-zero, cross-attention gates set to 0.5 in both
trees), the loss, the MoE aux loss, the MTP loss and every gradient
leaf, prefill's logits and cache, and 3 decode steps against the JAX
reference; the encoder embeddings of the cross blocks come from the
token stream (training) and from a seeded draw (prefill)."""
import functools

import jax
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import synthetic_token_batches as ref_batches
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.models.model import build_model
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_unflatten)

# port against reference, f32: sums in another order (measured on the
# CPU: the loss within 2.3e-7 relative, each gradient leaf within 3.6e-6
# of its largest entry, 4.0e-6 at deepseek-v3 and 6.8e-6 at
# llama-3.2-vision (a cross layer's gate); prefill, cache and decode
# within 7.5e-6)
REL = 1e-5
# gradients through Mamba2 blocks (the A_log leaves, and at jamba's 16
# layers every leaf): the decay's gradient sums terms scaled by the
# cumulative dt, which cancel, and the backward carries that error down
# the stack.  Two f32 evaluations differ by more than 1e-5: the
# reference's own f32 gradients lie up to 1.2e-5 (mamba2-130m) and 3.1e-5
# (jamba) of the largest entry from an f64 evaluation of the same
# function, the port's 1.5e-5 and 4.3e-5; port against reference 1.07e-5
# (mamba2's A_log) and 2.4e-5 (jamba)
SSD_GRAD_REL = 5e-5
# a cross-attention gate starts at 0 (tanh(0) = 0: the layer adds
# nothing and its projections' gradients are exactly 0), so the parity
# checks set every gate to this in both packages' params
GATE = 0.5
JIT_INIT = ("deepseek-v3-671b", "llama-3.2-vision-90b")


def close(a, b, what, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


@functools.lru_cache(maxsize=1)
def _setup(arch):
    rmodel = RefModel(ref_get_arch(arch).reduced())
    # the jitted init draws the eager init's values up to the last bits
    # and takes seconds less; the archs held before latent and cross
    # attention keep the eager draws their margins were measured on
    init = jax.jit(rmodel.init) if arch in JIT_INIT else rmodel.init
    rparams = jax.tree_util.tree_map(np.asarray,
                                     init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    rparams = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if jax.tree_util.keystr(path).endswith("['b']") else x, rparams)
    rparams = set_gates(rparams)
    return rmodel, rparams, build_model(get_arch(arch).reduced())


def set_gates(rparams, value: float = GATE):
    """The reference's numpy params with every cross-attention gate
    leaf set to ``value``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.full_like(x, value)
        if jax.tree_util.keystr(path).endswith("['gate']") else x, rparams)


def torch_batch(batch):
    """A numpy batch as tensors: ids int64, embeddings as they are."""
    return {k: torch.from_numpy(v) if v.dtype.kind == "f"
            else torch.from_numpy(v).long() for k, v in batch.items()}


def check_loss_grads_prefill_decode(arch):
    rmodel, rparams, model = _setup(arch)
    tree = params_from_numpy(rparams)
    if arch == "qwen2-1.5b":
        biases = [x for p, x in tree_leaves_with_path(tree) if p[-1] == "b"]
        assert len(biases) == 3 and all(b.abs().max() > 0 for b in biases)
    cfg = model.cfg
    gates = [x for p, x in tree_leaves_with_path(tree) if p[-1] == "gate"]
    assert all(bool((g == GATE).all()) for g in gates)
    assert len(gates) == cfg.block_pattern.count("cross")
    # the loss and every gradient leaf
    batch = next(ref_batches(512, 2, 32, seed=3,
                             encoder_tokens=cfg.num_encoder_tokens,
                             encoder_dim=cfg.encoder_dim))
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tree)]
    loss, metrics = model.loss(tree_unflatten(tree, leaves),
                               torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(rparams, batch)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=REL)
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               float(rmetrics["aux_loss"]), rtol=REL)
    assert (float(metrics["aux_loss"]) > 0) == (model.cfg.moe is not None)
    assert float(metrics["tokens"]) == float(rmetrics["tokens"])
    assert metrics.keys() == rmetrics.keys()
    if cfg.mtp_depth:
        np.testing.assert_allclose(float(metrics["mtp_loss"]),
                                   float(rmetrics["mtp_loss"]), rtol=REL)
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    rleaves = jax.tree_util.tree_leaves(rgrads)
    assert len(rleaves) == len(grads)
    for path, a, b in zip(paths, grads, rleaves):
        ssd = path[-1] == "A_log" or arch == "jamba-v0.1-52b"
        close(a.numpy(), b, str(path), SSD_GRAD_REL if ssd else REL)
    # prefill of 24 tokens into a 27-slot cache, then 3 decode steps
    B, S, G = 2, 24, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (B, S + G)).astype(np.int32)
    prompt = {"tokens": toks[:, :S]}
    if cfg.num_encoder_tokens:
        prompt["encoder_embeds"] = rng.standard_normal(
            (B, cfg.num_encoder_tokens, cfg.encoder_dim)).astype(np.float32)
    rlogits, rcache = jax.jit(lambda p, b: rmodel.prefill(
        p, b, cache_len=S + G))(rparams, prompt)
    with torch.no_grad():
        logits, cache = model.prefill(tree, torch_batch(prompt),
                                      cache_len=S + G)
    close(logits.numpy(), rlogits, "prefill logits")
    rdecode = jax.jit(rmodel.decode_step)
    for pos in range(S, S + G):
        rlogits, rcache = rdecode(rparams, rcache, toks[:, pos:pos + 1], pos)
        with torch.no_grad():
            logits, cache = model.decode_step(
                tree, cache, torch.from_numpy(toks[:, pos:pos + 1]).long(),
                pos)
        close(logits.numpy(), rlogits, f"decode at {pos}")
    assert cache.keys() == rcache.keys()
    for pos_key, c in cache.items():
        assert c.keys() == rcache[pos_key].keys()
        for key, x in c.items():
            if key == "pos":
                np.testing.assert_array_equal(x.numpy(),
                                              rcache[pos_key][key])
            else:
                close(x.numpy(), rcache[pos_key][key],
                       f"cache {pos_key} {key}")
