"""The port's latent attention (``layers.init_mla``, ``mla_fwd``,
``mla_decode``, ``init_mla_cache``) and multi-token prediction head
(``Model._mtp_loss``) against the JAX reference's at deepseek-v3-671b's
smoke config (f32: d_model 256, 8 heads, q_lora 64, kv_lora 32, nope 32,
rope 16, v 32), with the reference's weights carried across: the
output, the cache (latent and rope key) and the gradients of the input
and of every weight; 3 absorbed decode steps after a prefill, against
the reference's and against the expanded form over the longer prompt;
the empty cache; the MTP loss at an S - 1 where the reference's chunk
rules collapse, with its block's MoE aux discarded; and the reference's
"mla" block kind, which the port refuses."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_arch_checks import torch_batch
from repro.configs import get_arch as ref_get_arch
from repro.data import synthetic_token_batches as ref_batches
from repro.models import layers as RL
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.models import flash
from repro_torch.models import layers as L
from repro_torch.models.model import build_model, xent_chunk_plan
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, \
    tree_unflatten

# port against reference, f32: sums in another order (measured on the
# CPU: <= 3.0e-6 of the largest entry on every output, cache entry and
# gradient)
REL = 1e-5
ARCH = "deepseek-v3-671b"


def _close(a, b, what, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


def _cfgs():
    return ref_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()


def _weights(rcfg):
    return jax.tree_util.tree_map(np.asarray, RL.init_mla(
        jax.random.PRNGKey(0), rcfg, jnp.float32))


def _draw(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("S", [24, 97])
def test_mla_fwd_matches_reference(S):
    """y, c_kv and k_rope, and the gradients of sum(y * r) + sum(c_kv *
    rc) + sum(k_rope * rk) with respect to x and every weight leaf.  S =
    97 is one query chunk in both; the expanded form's flash runs with
    qk width nope + rope = 48 and v width 32."""
    rcfg, cfg = _cfgs()
    rp = _weights(rcfg)
    B, m = 2, cfg.mla
    x = _draw(B, S, cfg.d_model)
    r = _draw(B, S, cfg.d_model, seed=1)
    rc = _draw(B, S, m.kv_lora_rank, seed=2)
    rk = _draw(B, S, m.qk_rope_head_dim, seed=3)

    def ref_obj(p, x):
        y, (c, k) = RL.mla_fwd(p, rcfg, x, jnp.arange(S))
        return (y * r).sum() + (c * rc).sum() + (k * rk).sum(), (y, c, k)

    (_, (ry, rc_kv, rk_rope)), rgrads = jax.jit(jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True))(rp, x)
    tree = params_from_numpy(rp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, (c_kv, k_rope) = L.mla_fwd(tree_unflatten(tree, leaves), cfg, xt,
                                  torch.arange(S))
    obj = (y * torch.from_numpy(r)).sum() + (c_kv * torch.from_numpy(rc)) \
        .sum() + (k_rope * torch.from_numpy(rk)).sum()
    grads = torch.autograd.grad(obj, leaves + [xt])
    assert c_kv.shape == (B, S, m.kv_lora_rank)
    assert k_rope.shape == (B, S, m.qk_rope_head_dim)
    _close(y.detach(), ry, "y")
    _close(c_kv.detach(), rc_kv, "c_kv")
    _close(k_rope.detach(), rk_rope, "k_rope")
    paths = [str(p) for p, _ in tree_leaves_with_path(tree)] + ["x"]
    want = jax.tree_util.tree_leaves(rgrads[0]) + [rgrads[1]]
    assert len(want) == len(grads)
    for path, a, b in zip(paths, grads, want):
        assert float(np.abs(np.asarray(b)).max()) > 0, path
        _close(a, b, "d" + path)


def test_mla_decode_matches_reference():
    """A prefill of 20 tokens through mla_fwd into a 23-slot cache, then
    3 absorbed decode steps: each step's output and the whole cache
    against the reference's mla_decode, and the last step's output
    against the expanded form over all 23 tokens (the two forms are
    equal up to the order of f32 sums)."""
    rcfg, cfg = _cfgs()
    rp = _weights(rcfg)
    tree = params_from_numpy(rp)
    B, S, G = 2, 20, 3
    x = _draw(B, S + G, cfg.d_model)
    _, (rc, rk) = jax.jit(lambda p, x: RL.mla_fwd(p, rcfg, x, jnp.arange(
        S)))(rp, x[:, :S])
    rdecode = jax.jit(lambda p, x, c, pos: RL.mla_decode(p, rcfg, x, c, pos))
    rcache = RL.init_mla_cache(rcfg, B, S + G, jnp.float32)
    rcache = {"c_kv": rcache["c_kv"].at[:, :S].set(rc),
              "k_rope": rcache["k_rope"].at[:, :S].set(rk),
              "pos": rcache["pos"].at[:S].set(jnp.arange(S))}
    cache = L.init_mla_cache(cfg, B, S + G, torch.float32, "cpu")
    with torch.no_grad():
        _, (c_kv, k_rope) = L.mla_fwd(tree, cfg, torch.from_numpy(x[:, :S]),
                                      torch.arange(S))
        cache["c_kv"][:, :S] = c_kv
        cache["k_rope"][:, :S] = k_rope
        cache["pos"][:S] = torch.arange(S, dtype=torch.int32)
        for pos in range(S, S + G):
            ry, rcache = rdecode(rp, x[:, pos:pos + 1], rcache, pos)
            y, cache = L.mla_decode(tree, cfg,
                                    torch.from_numpy(x[:, pos:pos + 1]),
                                    cache, pos)
            _close(y, ry, f"decode at {pos}")
        full, _ = L.mla_fwd(tree, cfg, torch.from_numpy(x),
                            torch.arange(S + G))
    _close(y, full[:, -1:], "absorbed vs expanded")
    for key in ("c_kv", "k_rope"):
        _close(cache[key], rcache[key], key)
    np.testing.assert_array_equal(cache["pos"].numpy(), rcache["pos"])
    with pytest.raises(IndexError):
        L.mla_decode(tree, cfg, torch.from_numpy(x[:, :1]), cache, S + G)


def test_init_mla_cache_matches_reference():
    """Shapes, dtypes and the int32-max positions, stacked over blocks as
    Model.init_cache stacks them, against the reference's init_cache."""
    rcfg, cfg = _cfgs()
    rcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in (rcfg, cfg))
    rcache = RefModel(rcfg).init_cache(3, 10)
    cache = build_model(cfg).init_cache(3, 10)
    assert cache.keys() == rcache.keys() == {"p0"}
    assert cache["p0"].keys() == rcache["p0"].keys()
    for key, x in cache["p0"].items():
        want = np.asarray(rcache["p0"][key])
        assert tuple(x.shape) == want.shape, key
        assert str(x.dtype).split(".")[-1] == str(want.dtype), key
        np.testing.assert_array_equal(x.float().numpy(),
                                      want.astype(np.float32))


@functools.lru_cache(maxsize=1)
def _mtp_setup():
    """The smoke config cut to one block: the trunk, then the MTP
    block."""
    rcfg, cfg = (dataclasses.replace(c, n_layers=1) for c in _cfgs())
    rmodel = RefModel(rcfg)
    rparams = jax.tree_util.tree_map(np.asarray, jax.jit(rmodel.init)(
        jax.random.PRNGKey(0)))
    return rmodel, rparams, build_model(cfg)


def test_mtp_loss_where_the_reference_chunk_rules_collapse():
    """At S = 576 the trunk's chunks are whole in both (64-row query
    chunks), but the MTP block runs at S - 1 = 575: the reference's
    flash halves its query chunk to 1 row and its cross-entropy chunk to
    1 row, where the port pads to 512.  The loss, xent, aux, mtp_loss
    and every gradient leaf (the "mtp" subtree's included) against the
    reference's."""
    rmodel, rparams, model = _mtp_setup()
    S = 576
    assert flash._chunks(S - 1, S - 1) == (1, 575)
    assert flash.chunk_plan(S - 1, S - 1) == (512, 575, 1024, 575)
    assert xent_chunk_plan(S - 1, 512) == (512, 1024)
    batch = next(ref_batches(512, 1, S, seed=4))
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(rparams, batch)
    tree = params_from_numpy(rparams)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    loss, metrics = model.loss(tree_unflatten(tree, leaves),
                               torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert metrics.keys() == rmetrics.keys()
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(rmetrics[key]),
                                   rtol=REL, err_msg=key)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=REL)
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    rleaves = jax.tree_util.tree_leaves(rgrads)
    assert len(rleaves) == len(grads)
    assert sum(p[0] == "mtp" for p in paths) > 10
    for path, a, b in zip(paths, grads, rleaves):
        _close(a, b, str(path))


def test_mtp_block_aux_is_discarded():
    """The loss is (xent + 0.3 x mtp_loss) + aux, where aux sums the
    trunk's MoE layers alone: the same params without the "mtp" subtree,
    on a model without the head, give the same xent and aux."""
    rmodel, rparams, model = _mtp_setup()
    batch = torch_batch(next(ref_batches(512, 2, 32, seed=5)))
    tree = params_from_numpy(rparams)
    with torch.no_grad():
        loss, m = model.loss(tree, batch)
        trunk = build_model(dataclasses.replace(model.cfg, mtp_depth=0))
        _, m0 = trunk.loss({k: v for k, v in tree.items() if k != "mtp"},
                           batch)
    assert float(m["aux_loss"]) > 0
    assert torch.equal(m["aux_loss"], m0["aux_loss"])
    assert torch.equal(m["xent"], m0["xent"])
    assert torch.equal(loss, (m["xent"] + 0.3 * m["mtp_loss"])
                       + m["aux_loss"])


def test_mla_block_kind_raises():
    """The reference builds a "mla" position's params but skips its mixer
    in the loss, the prefill and decode, and its init_cache raises; the
    port refuses the kind when the model is built."""
    cfg = get_arch(ARCH).reduced()
    with pytest.raises(ValueError, match="'mla'"):
        build_model(dataclasses.replace(cfg, block_pattern=("mla",)))
    with pytest.raises(ValueError, match="Queue 3"):
        build_model(dataclasses.replace(cfg, block_pattern=("attn", "mla"),
                                        n_layers=4))
    with pytest.raises(ValueError):
        RefModel(dataclasses.replace(ref_get_arch(ARCH).reduced(),
                                     block_pattern=("mla",))).init_cache(1, 4)
