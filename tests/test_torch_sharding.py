"""The port's partitioning rules (``repro_torch.dist.sharding``) against
the reference's (``repro.dist.sharding``), in this process, no device:
on all ten assigned archs every parameter, AdamW-state and cache spec
equals the reference's ``PartitionSpec`` as a tuple and every
``local_shape`` equals the reference's, at model sizes 1, 2, 4 and 16,
with FSDP off and over ``data`` = 16, and for the caches of the four
input shapes on both dp layouts, with and without the sequence axis.
Then the hazards of the rules, each against the reference."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import TrainConfig as RTC
from repro.dist import sharding as RS
from repro.models.model import Model as RefModel
from repro.optim.optimizers import build_optimizer as ref_build_optimizer
from repro.utils.tree import keystr_path as ref_keystr
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import sharding as SH
from repro_torch.launch.input_specs import cache_specs, params_specs
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import build_optimizer
from repro_torch.utils.tree import keystr_path, tree_leaves_with_path

MODEL_SIZES = (1, 2, 4, 16)
DATA = 16
DP_LAYOUTS = ((("data",), 16), (("pod", "data"), 32))


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    """The reference's params and AdamW state of ``arch`` (eval_shape)."""
    model = RefModel(ref_get_arch(arch))
    p = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    o = jax.eval_shape(ref_build_optimizer(RTC(optimizer="adamw")).init, p)
    return model, p, o


def _ref_specs(spec_tree, shape_tree):
    """{path: (shape, tuple(spec))} of a reference spec tree."""
    shapes = jax.tree_util.tree_flatten_with_path(shape_tree)[0]
    specs = jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, RS.P))
    return {ref_keystr(path): (tuple(leaf.shape), tuple(s))
            for (path, leaf), s in zip(shapes, specs)}


def _check(ours, ref_tree, ref_spec_tree, sizes, where):
    """The port's {path: spec} against the reference's: the same paths in
    the same order, each spec and each local shape equal."""
    ref = _ref_specs(ref_spec_tree, ref_tree)
    assert list(ours) == list(ref), where
    for path, (shape, rspec) in ref.items():
        assert ours[path] == rspec, (where, path, shape)
        assert SH.local_shape(shape, ours[path], sizes) == \
            RS.local_shape(shape, RS.P(*rspec), sizes), (where, path)


def _tree_with_shapes(tree):
    return {ref_keystr(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_and_local_shapes_match_reference(arch):
    rmodel, rparams, ropt = _ref_trees(arch)
    model = build_model(get_arch(arch))
    params = params_specs(model)
    opt = build_optimizer(TrainConfig(optimizer="adamw")).init(params)
    for ours, ref in ((params, rparams), (opt, ropt)):
        assert {keystr_path(p): tuple(x.shape)
                for p, x in tree_leaves_with_path(ours)} == \
            _tree_with_shapes(ref)
    for mp in MODEL_SIZES:
        for fsdp in ((), ("data",)):
            kw = dict(model_size=mp, fsdp_axes=fsdp,
                      fsdp_size=DATA if fsdp else 1)
            sizes = {"model": mp, "data": DATA}
            for ours, ref in ((params, rparams), (opt, ropt)):
                _check(SH.param_pspecs(ours, **kw), ref,
                       RS.param_pspecs(ref, **kw), sizes, (arch, kw))
    # the caches of the four input shapes on both dp layouts
    for name, shape in INPUT_SHAPES.items():
        rcache = jax.eval_shape(lambda: rmodel.init_cache(
            REF_SHAPES[name].global_batch, REF_SHAPES[name].seq_len))
        cache = cache_specs(model, shape)
        assert {keystr_path(p): tuple(x.shape)
                for p, x in tree_leaves_with_path(cache)} == \
            _tree_with_shapes(rcache), (arch, name)
        for dp_axes, dp_size in DP_LAYOUTS:
            for mp in (1, 16):
                for seq in (None, "data"):
                    kw = dict(dp_axes=dp_axes, dp_size=dp_size,
                              model_size=mp, seq_shard_axis=seq)
                    sizes = {"model": mp, "data": 16, "pod": dp_size // 16}
                    _check(SH.cache_pspecs(cache, **kw), rcache,
                           RS.cache_pspecs(rcache, **kw), sizes,
                           (arch, name, kw))


def _both(path, shape, **kw):
    """The port's spec of one leaf, asserted equal to the reference's."""
    ours = SH.partition_spec(path, shape, **kw)
    assert ours == tuple(RS.partition_spec(path, shape, **kw)), (path, kw)
    return ours


def test_fsdp_choice_hazards():
    fsdp = dict(fsdp_axes=("data",), fsdp_size=16)
    # a tie between two dims of one size: the lowest index takes FSDP
    assert _both("blocks/p0/mixer/conv/x", (64, 64), **fsdp) == \
        ("data", None)
    # the leading n_blocks dim of a stack is a candidate like any other
    assert _both("blocks/p0/mixer/a_log", (32, 16), **fsdp) == \
        ("data", None)
    assert _both("blocks/p0/ffn/w_up/w", (32, 2048, 8192), model_size=16,
                 **fsdp) == (None, "data", "model")
    # FSDP skips a norm scale but not a bias; model skips both
    assert _both("blocks/p0/mixer/norm/scale", (32, 2048), model_size=16,
                 **fsdp) == (None, None)
    assert _both("blocks/p0/mixer/wq/b", (32, 2048), model_size=16,
                 **fsdp) == (None, "data")
    # whole segments: "embed" in a longer name is not the embedding
    assert _both("blocks/p0/embedder/w", (512, 256), model_size=16) == \
        (None, None)
    assert _both("embed/w", (512, 256), model_size=16) == ("model", None)
    # a role dim that model does not divide is replicated, and FSDP may
    # then take it
    assert _both("blocks/p0/mixer/wq/w", (4, 64, 24), model_size=16,
                 **fsdp) == (None, "data", None)
    # an expert stack: the expert dim over model
    assert _both("blocks/p0/ffn/w_gate", (2, 16, 64, 32), model_size=16) \
        == (None, "model", None, None)


def test_cache_hazards():
    # dp on dim 1 whenever it divides: the (n_blocks, S) ring's S too
    ring = {"p0": {"pos": torch.empty((4, 4096), device="meta"),
                   "k": torch.empty((4, 1, 4096, 8, 64), device="meta")}}
    rring = {"p0": {"pos": jax.ShapeDtypeStruct((4, 4096), "int32"),
                    "k": jax.ShapeDtypeStruct((4, 1, 4096, 8, 64),
                                              "bfloat16")}}
    for kw in (dict(dp_axes=("pod", "data"), dp_size=32, model_size=8,
                    seq_shard_axis="data"),
               dict(dp_axes=("data",), dp_size=16, model_size=16),
               dict(dp_axes=(), dp_size=1, model_size=3)):
        ours = SH.cache_pspecs(ring, **kw)
        ref = _ref_specs(RS.cache_pspecs(rring, **kw), rring)
        assert {p: s for p, (_, s) in ref.items()} == ours, kw
    ours = SH.cache_pspecs(ring, dp_axes=("pod", "data"), dp_size=32,
                           model_size=8, seq_shard_axis="data")
    assert ours["p0/pos"] == (None, ("pod", "data"))
    # batch 1: the sequence over the seq axis, the heads over model
    assert ours["p0/k"] == (None, None, "data", "model", None)


def test_entries_and_local_shape_refusal():
    assert ASSIGNED_ARCHS == REF_ARCHS
    # one axis is the bare name, as JAX normalises P(("data",))
    assert SH.batch_pspec(("data",)) == ("data",) == \
        tuple(RS.batch_pspec(("data",)))
    assert SH.batch_pspec(("pod", "data")) == (("pod", "data"),) == \
        tuple(RS.batch_pspec(("pod", "data")))
    assert SH.batch_pspec(()) == (None,) == tuple(RS.batch_pspec(()))
    assert tuple(RS.P(("data",))) == ("data",)
    spec = SH.partition_spec("blocks/p0/mixer/wq/b", (4, 32),
                             fsdp_axes=("data",), fsdp_size=16)
    assert spec == (None, "data") and isinstance(spec[1], str)
    # local_shape refuses a dim its axes do not divide (the reference
    # asserts)
    assert SH.local_shape((48, 64), (("pod", "data"), "model"),
                          {"pod": 2, "data": 8, "model": 16}) == (3, 4)
    with pytest.raises(ValueError, match="does not divide"):
        SH.local_shape((24, 64), (("pod", "data"), None),
                       {"pod": 2, "data": 16})
    with pytest.raises(AssertionError):
        RS.local_shape((24, 64), RS.P(("pod", "data"), None),
                       {"pod": 2, "data": 16})
    np.testing.assert_equal(SH.local_shape((5,), (None,), {}), (5,))
