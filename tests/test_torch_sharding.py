"""The port's partitioning rules (``repro_torch.dist.sharding``) against
the reference's (``repro.dist.sharding``), in this process, no device:
on all ten assigned archs every parameter, AdamW-state and cache spec
equals the reference's ``PartitionSpec`` as a tuple and every
``local_shape`` equals the reference's, at model sizes 1, 2, 4 and 16,
with FSDP off and over ``data`` = 16, and for the caches of the four
input shapes on both dp layouts, with and without the sequence axis.
Then the hazards of the rules, each against the reference.

And the sweep of ``--model-shards`` on the meta device: each of the ten
archs at its published widths (one superblock deep), one rank of model
sizes 2, 4, 8 and 16 (and deepseek-v3-671b's of 6 and 12), whose group
hands back shape-right tensors, trains (forward and backward), prefills
and decodes a step; every held
leaf (params, gradients, cache) has its ``local_shape`` under the
reference's spec.  At model 16 nine of the ten archs split a head
(half a kv head of llama3.2-1b, granite-8b, jamba and vision; qwen2's 12
query heads; phi3's 10 kv heads; musicgen's 24 heads; arctic's 8 kv
heads; mamba2-130m's 24 Mamba2 heads); deepseek-v3-671b's 128 latent
heads split at model 6 and 12."""
import functools
from dataclasses import replace

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
from repro_torch.dist.tp import Shards
from repro_torch.launch.input_specs import cache_specs, params_specs
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import build_optimizer
from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path, tree_unflatten)

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


class _MetaGroup:
    """The model group of ``size`` shards seen from shard ``index`` on
    the meta device: every collective returns a tensor of its shape (a
    gather repeats this shard's block), so one rank's step runs alone."""

    def __init__(self, size, index):
        self.size, self.index = size, index

    def all_gather(self, x, dim):
        return torch.cat([x] * self.size, dim)

    def all_reduce(self, x, op=None):
        return x.clone()

    def reduce_scatter(self, x, dim):
        w = x.shape[dim] // self.size
        return x.narrow(dim, self.index * w, w).contiguous()


def _one_superblock(cfg):
    return replace(cfg, n_layers=len(cfg.block_pattern))


@functools.lru_cache(maxsize=None)
def _ref_one_superblock(arch):
    """The reference's params (eval_shape) of ``arch`` one superblock
    deep."""
    rcfg = ref_get_arch(arch)
    rcfg = replace(rcfg, n_layers=len(rcfg.block_pattern))
    return jax.eval_shape(RefModel(rcfg).init, jax.random.PRNGKey(0))


# every arch at model 2, 4, 8 and 16, and deepseek-v3-671b where the
# model axis cuts its 128 latent-attention heads (21 1/3 and 10 2/3 a
# shard: wq_b's 24576 columns in blocks that cut a head, wkv_b's 32768
# and wo's 16384 rows replicated)
META_CASES = [(arch, mp) for mp in (2, 4, 8, 16) for arch in ASSIGNED_ARCHS] \
    + [("deepseek-v3-671b", 6), ("deepseek-v3-671b", 12)]


@pytest.mark.parametrize("arch,mp", META_CASES)
def test_model_shards_step_on_the_meta_device(arch, mp):
    """The last shard of ``mp`` (the one a head's slots run past, where
    the heads do not divide) trains, prefills and decodes one step at
    published widths: nothing raises, and the held params, their
    gradients and the cache have the reference's local shapes."""
    cfg = _one_superblock(get_arch(arch))
    m, B, S = mp - 1, 2, 8
    full = build_model(cfg).init(torch.Generator(), "meta")
    specs = SH.param_pspecs(full, model_size=mp)
    sizes = {"model": mp}
    ref = _ref_specs(RS.param_pspecs(_ref_one_superblock(arch),
                                     model_size=mp),
                     _ref_one_superblock(arch))
    assert {k: s for k, (_, s) in ref.items()} == specs, arch
    local = SH.shard_tree(full, specs, {"model": m}, sizes)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(local)]
    model = Model(cfg, Shards(model=_MetaGroup(mp, m), specs=specs))
    tokens = torch.empty((B, S), dtype=torch.int64, device="meta")
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.num_encoder_tokens:
        batch["encoder_embeds"] = torch.empty(
            (B, cfg.num_encoder_tokens, cfg.encoder_dim), device="meta")
    loss, _ = model.loss(tree_unflatten(local, leaves), batch, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    for (path, x), g in zip(tree_leaves_with_path(full), grads):
        key = keystr_path(path)
        want = SH.local_shape(tuple(x.shape), ref[key][1], sizes)
        assert tuple(g.shape) == want, (arch, mp, key, g.shape)
    serve = {k: x for k, x in batch.items() if k != "labels"}
    logits, cache = model.prefill(local, serve, cache_len=S + 1)
    logits, cache = model.decode_step(local, cache, tokens[:, :1], S)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    whole = build_model(cfg).init_cache(B, S + 1, "meta")
    cspecs = SH.cache_pspecs(whole, dp_axes=(), dp_size=1, model_size=mp)
    for (path, x), c in zip(tree_leaves_with_path(whole), tree_leaves(cache)):
        key = keystr_path(path)
        assert tuple(c.shape) == SH.local_shape(tuple(x.shape), cspecs[key],
                                                sizes), (arch, mp, key)
