"""The arch parity check shared by tests/test_torch_archs*.py: at an arch's
``reduced()`` config (f32), with the reference's weights carried across
(QKV biases drawn non-zero), the loss, the MoE aux loss and every
gradient leaf, prefill's logits and cache, and 3 decode steps against
the JAX reference."""
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
# of its largest entry; prefill, cache and decode within 7.5e-6)
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


def close(a, b, what, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


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


def check_loss_grads_prefill_decode(arch):
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
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               float(rmetrics["aux_loss"]), rtol=REL)
    assert (float(metrics["aux_loss"]) > 0) == (model.cfg.moe is not None)
    assert float(metrics["tokens"]) == float(rmetrics["tokens"])
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    rleaves = jax.tree_util.tree_leaves(rgrads)
    assert len(rleaves) == len(grads)
    for path, a, b in zip(paths, grads, rleaves):
        ssd = path[-1] == "A_log" or arch == "jamba-v0.1-52b"
        close(a.numpy(), b, str(path), SSD_GRAD_REL if ssd else REL)
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
