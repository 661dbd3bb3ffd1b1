"""The port's dense decoder against the JAX reference on the llama3.2-1b
smoke config (f32) with carried weights: the loss and every leaf of its
gradient, and the synthetic token stream bit for bit."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import synthetic_token_batches as ref_batches
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.data import synthetic_token_batches
from repro_torch.models.model import build_model
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, \
    tree_unflatten


@functools.lru_cache(maxsize=1)
def _setup():
    rcfg = ref_get_arch("llama3.2-1b").reduced()
    rmodel = RefModel(rcfg)
    params = jax.tree_util.tree_map(
        np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    batch = next(ref_batches(rcfg.vocab_size, 2, 32, seed=3))
    return rmodel, params, batch


def test_token_stream_matches_reference():
    ours = synthetic_token_batches(512, 3, 16, seed=5)
    ref = ref_batches(512, 3, 16, seed=5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_loss_and_grads_match_reference():
    """Loss to rtol 1e-5; each gradient leaf to 1e-5 of its own largest
    entry: f32 sums in another order (measured on the CPU: loss exact,
    gradients <= 2.0e-6 of the leaf's largest entry)."""
    rmodel, params, batch = _setup()
    model = build_model(get_arch("llama3.2-1b").reduced())
    tree = params_from_numpy(params)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tree)]
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, metrics = model.loss(tree_unflatten(tree, leaves), tbatch)
    grads = torch.autograd.grad(loss, leaves)
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(params, batch)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
    assert float(metrics["tokens"]) == float(rmetrics["tokens"])
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    for path, a, b in zip(paths, grads, jax.tree_util.tree_leaves(rgrads)):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=1e-5, err_msg=str(path))


def test_init_is_seeded_and_shaped_like_reference():
    cfg = get_arch("llama3.2-1b").reduced()
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(1))
    b = model.init(torch.Generator().manual_seed(1))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    _, params, _ = _setup()
    assert [tuple(l.shape) for l in tree_leaves(a)] == \
        [tuple(l.shape) for l in jax.tree_util.tree_leaves(params)]


def test_non_dense_family_raises():
    """The model dispatches on the block pattern, as the reference's
    does: an unknown block kind raises ValueError, and so does the
    reference's "mla" kind, whose mixer the reference's forward skips
    (latent attention is cfg.mla on "attn" positions; ROADMAP.md Queue
    3); every one of the reference's ten assigned archs builds on the
    meta device with the reference's parameter count."""
    import dataclasses
    from repro.configs import ASSIGNED_ARCHS
    from repro.configs import get_arch as ref_get_arch
    from repro.models.model import Model as RefModel
    llama = get_arch("llama3.2-1b")
    for kind in ("conv", "mla"):
        cfg = dataclasses.replace(llama, block_pattern=("attn", kind))
        with pytest.raises(ValueError, match=repr(kind)):
            build_model(cfg)
    cfg = get_arch("musicgen-medium")
    assert cfg.family == "audio"
    assert build_model(cfg).param_count() == 1818379776
    for arch in ASSIGNED_ARCHS:
        assert build_model(get_arch(arch)).param_count() == \
            RefModel(ref_get_arch(arch)).param_count(), arch
    assert build_model(get_arch("deepseek-v3-671b")).param_count() == \
        715_408_317_440
    assert build_model(get_arch("llama-3.2-vision-90b")).param_count() == \
        87_383_678_996


@pytest.fixture
def deterministic():
    """The CPU's index_put accumulate (the embedding's backward) adds the
    rows of repeated tokens in a thread-dependent order, so the embedding
    gradient differs run to run, with or without remat; its
    deterministic algorithm fixes the order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _remat_setup():
    cfg = get_arch("llama3.2-1b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(4))
    batch = {k: torch.from_numpy(v).long() for k, v in next(
        synthetic_token_batches(cfg.vocab_size, 4, 48, seed=6)).items()}
    return model, params, batch


def test_remat_changes_no_bit(deterministic):
    """Model.loss with each block and each cross-entropy chunk under
    checkpoint (remat None, the default, and True) gives the loss and
    every gradient leaf bit for bit as without it."""
    model, params, batch = _remat_setup()
    got = {}
    for remat in (None, True, False):
        leaves = [p.clone().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), batch,
                             remat=remat)
        got[remat] = [loss.detach()] + list(torch.autograd.grad(loss,
                                                                leaves))
    for remat in (None, True):
        for a, b in zip(got[remat], got[False]):
            assert torch.equal(a, b)


def test_remat_changes_no_bit_through_node_grads(deterministic):
    """The trainer's per-node gradients at K = 2 (params reaching the
    checkpointed blocks through a closure): the same bits with remat as
    without."""
    from repro_torch.launch.steps import node_grads
    model, params, batch = _remat_setup()
    n = sum(p.numel() for p in tree_leaves(params))
    g1, m1 = node_grads(functools.partial(model.loss, remat=True), params,
                        batch, 2, n)
    g0, m0 = node_grads(functools.partial(model.loss, remat=False), params,
                        batch, 2, n)
    assert g1.abs().sum() > 0
    assert torch.equal(g1, g0)
    assert torch.equal(m1["loss"], m0["loss"])


def test_xent_chunk_plan_pads_where_the_reference_collapses():
    """The reference halves its cross-entropy chunk until it divides S;
    from a target of 48 rows that reaches 1 row at S = 100.  The port
    keeps the reference's chunk where it is >= min(target, 32) rows (or
    S), else pads to a power-of-two chunk: the loss and the gradient of
    h equal the reference's within f32 rounding (padded rows add 0)."""
    import jax.numpy as jnp
    from repro.models.model import _chunked_xent as ref_xent
    from repro_torch.models.model import _chunked_xent, xent_chunk_plan
    assert xent_chunk_plan(128, 130) == (32, 128)    # llama's, kept
    assert xent_chunk_plan(4096, 333) == (256, 4096)  # 2 rows in the ref
    assert xent_chunk_plan(128, 333) == (128, 128)
    assert xent_chunk_plan(100, 48) == (32, 128)
    rng = np.random.default_rng(0)
    B, S, D, V = 2, 100, 16, 64
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, V)).astype(np.float32)
    labels = rng.integers(-1, V, (B, S)).astype(np.int32)
    target = 48 * 4 * B * V                # target_chunk_bytes: 48 rows
    th = torch.from_numpy(h).requires_grad_(True)
    xent, n = _chunked_xent(th, torch.from_numpy(w),
                            torch.from_numpy(labels).long(), target,
                            remat=True)
    (gh,) = torch.autograd.grad(xent, th)
    rx, rn = ref_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                      target)
    rgh = jax.grad(lambda x: ref_xent(x, jnp.asarray(w),
                                      jnp.asarray(labels), target)[0])(h)
    assert float(n) == float(rn) == float((labels >= 0).sum())
    np.testing.assert_allclose(float(xent), float(rx), rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(rgh), rtol=0,
                               atol=1e-6 * float(np.abs(rgh).max()))
