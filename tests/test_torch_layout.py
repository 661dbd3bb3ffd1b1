"""The port's flat-gradient layout and fused-sweep metadata against the
JAX reference: leaf order, offsets, roles, k, and the sweep's extract /
block / seg / kcap / n_cand, field for field."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import sparsify as RSP
from repro.models.model import Model as RefModel
from repro.utils.tree import tree_flatten_vector as ref_flatten
from repro_torch.configs import get_arch
from repro_torch.core import sparsify as SP
from repro_torch.models.model import build_model
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_flatten_vector

ROLES = (SP.ROLE_COMPRESSED, SP.ROLE_TOPK_ONLY)


def _leaves(layout):
    return [(l.path, l.offset, l.size, l.role, l.k) for l in layout.leaves]


def _assert_layout_equal(lt, lr):
    assert _leaves(lt) == _leaves(lr)
    assert (lt.n_total, lt.mu, lt.mu_pad, lt.k_last) == \
        (lr.n_total, lr.mu, lr.mu_pad, lr.k_last)


@functools.lru_cache(maxsize=1)
def _ref_smoke_params():
    cfg = ref_get_arch("llama3.2-1b").reduced()
    params = RefModel(cfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def test_flatten_order_matches_reference():
    ref_np = _ref_smoke_params()
    flat_ref = np.asarray(ref_flatten(ref_np))
    flat = tree_flatten_vector(params_from_numpy(ref_np)).numpy()
    np.testing.assert_array_equal(flat, flat_ref)


def test_smoke_layout_matches_reference():
    ref_np = _ref_smoke_params()
    _assert_layout_equal(
        SP.build_layout(params_from_numpy(ref_np), 0.001),
        RSP.build_layout(ref_np, 0.001))


def _big_k_params():
    # tests/test_bitonic.py's big-k layout: auto resolves bitonic
    return {"embed": {"w": np.zeros((16,), np.float32)},
            "mid": {"w": np.zeros((81920,), np.float32)},
            "fc": {"w": np.zeros((37,), np.float32)}}


@pytest.mark.parametrize("which,sparsity,extract", [
    ("smoke", 0.001, "auto"), ("smoke", 0.05, "loop"),
    ("smoke", 0.05, "bitonic"), ("big_k", 0.25, "auto"),
    ("big_k", 0.25, "loop")])
def test_fused_meta_matches_reference(which, sparsity, extract):
    tree = _ref_smoke_params() if which == "smoke" else _big_k_params()
    lt = SP.build_layout(params_from_numpy(tree), sparsity)
    lr = RSP.build_layout(tree, sparsity)
    ex, block, seg, kcap, n_cand, slots = SP._fused_meta(lt, ROLES, extract)
    rex, rblock, rseg, rkcap, rn_cand, rslots = RSP._fused_meta(
        lr, ROLES, extract)
    assert (ex, block, n_cand) == (rex, rblock, rn_cand)
    np.testing.assert_array_equal(seg, rseg)
    np.testing.assert_array_equal(kcap, rkcap)
    assert [l.path for l in slots] == [l.path for l in rslots]
    if which == "big_k" and extract == "auto":
        assert ex == "bitonic" and block == 32768
    assert SP.fused_plan_info(lt, extract=extract) == \
        RSP.fused_plan_info(lr, extract=extract)


@pytest.mark.parametrize("n_layers", [4, 16])
def test_full_width_layout_matches_reference(n_layers):
    """llama3.2-1b at published widths, from shapes only (meta tensors /
    eval_shape): layout, resolved extractor and block size agree."""
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), n_layers=n_layers)
    rcfg = dataclasses.replace(ref_get_arch("llama3.2-1b"),
                               n_layers=n_layers)
    lt = SP.build_layout(build_model(cfg).init(torch.Generator(), "meta"),
                         0.001)
    lr = RSP.build_layout(jax.eval_shape(RefModel(rcfg).init,
                                         jax.random.PRNGKey(0)), 0.001)
    _assert_layout_equal(lt, lr)
    for extract in ("auto", "loop", "bitonic"):
        slots = tuple(l for role in ROLES for l in lt.leaves
                      if l.role == role)
        rslots = tuple(l for role in ROLES for l in lr.leaves
                       if l.role == role)
        ex = SP._resolve_extract(extract, slots)
        assert ex == RSP._resolve_extract(extract, rslots)
        assert SP._fused_block(slots, ex) == RSP._fused_block(rslots, ex)
    assert SP._resolve_extract("auto", slots) == "bitonic"
    assert SP._fused_block(slots, "bitonic") == SP.FUSED_BLOCK_MAX
    if n_layers == 4:
        assert lt.n_total == 505_956_352


def test_param_count_and_dtypes_match_reference():
    cfg = get_arch("llama3.2-1b")
    rcfg = ref_get_arch("llama3.2-1b")
    shapes = jax.eval_shape(RefModel(rcfg).init, jax.random.PRNGKey(0))
    meta = build_model(cfg).init(torch.Generator(), "meta")
    ref_leaves = jax.tree_util.tree_leaves(shapes)
    from repro_torch.utils.tree import tree_leaves
    ours = tree_leaves(meta)
    assert [tuple(l.shape) for l in ours] == \
        [tuple(l.shape) for l in ref_leaves]
    assert all(l.dtype == torch.bfloat16 for l in ours)
    assert all(l.dtype == jnp.bfloat16 for l in ref_leaves)


@pytest.mark.parametrize("arch,size", [
    ("deepseek-v3-671b", "reduced"), ("deepseek-v3-671b", "published"),
    ("llama-3.2-vision-90b", "reduced"), ("llama-3.2-vision-90b",
                                          "published")])
def test_mla_cross_layout_matches_reference(arch, size):
    """The flat gradient layout (leaf order, offsets, roles, k per leaf)
    of deepseek-v3-671b (the MLA leaves, the "mtp" subtree) and of
    llama-3.2-vision-90b (the cross layers' (1,)-shaped gates, stacked
    to (n_blocks, 1)) equal to the reference's build_layout, from shapes
    only (meta tensors / eval_shape), at the smoke config and at
    published widths.  The "mtp/..." leaves are compressed (the role
    goes by path name)."""
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    if size == "reduced":
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    lt = SP.build_layout(build_model(cfg).init(torch.Generator(), "meta"),
                         0.001)
    lr = RSP.build_layout(jax.eval_shape(RefModel(rcfg).init,
                                         jax.random.PRNGKey(0)), 0.001)
    _assert_layout_equal(lt, lr)
    mtp = [l for l in lt.leaves if l.path.startswith("mtp/")]
    gates = [l for l in lt.leaves if l.path.endswith("/gate")]
    if arch == "deepseek-v3-671b":
        assert len(mtp) > 10 and not gates
        assert all(l.role == SP.ROLE_COMPRESSED for l in mtp)
        assert any(l.path.endswith("mixer/wkv_b/w") for l in lt.leaves)
    else:
        assert not mtp and len(gates) == 1
