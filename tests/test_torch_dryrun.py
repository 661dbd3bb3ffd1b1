"""The port's dry run on the meta device (``repro_torch.launch.dryrun``,
``input_specs``, ``roofline``, the rule functions of ``launch.steps``)
against the reference, in this process, no device and no compile:

- every params, cache and batch stand-in equals the reference's
  ``eval_shape`` leaf by leaf (path, shape, dtype) on all ten archs, but
  for the port's named dtypes: token ids int64 (the reference declares
  int32), encoder embeddings f32 (it declares the model dtype) and
  llama-3.2-vision-90b's cross cache f32 (it declares the model dtype,
  but its prefill returns f32; ROADMAP Queue 3);
- ``run_one``'s ``per_device_bytes`` equals the bytes the reference's
  own rules (``param_pspecs``, ``cache_pspecs``, ``_serve_pspecs``,
  ``_batch_pspecs``, ``local_shape``, the LGC template through its
  ``build_compressor``) give on the reference's own shapes, with those
  dtypes, on a stand-in mesh of the production shapes: ten archs x four
  shapes x both meshes for ``none`` and ``lgc_rar``, and all six methods
  on llama3.2-1b train_4k;
- ``model_flops`` equals ``repro.launch.roofline.model_flops`` to 1e-12;
- the long_500k substitution, the result file names, and ``--all``."""
import dataclasses
import functools
import json
import math
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import CompressionConfig as RCC
from repro.configs.base import TrainConfig as RTC
from repro.core import build_compressor as ref_build_compressor
from repro.dist import sharding as RS
from repro.launch import input_specs as RI
from repro.launch import roofline as RR
from repro.launch import steps as RSteps
from repro.launch.mesh import dp_axes_of, dp_size_of, model_size_of
from repro.models.model import Model as RefModel
from repro.optim.optimizers import build_optimizer as ref_build_optimizer
from repro.utils.tree import keystr_path as ref_keystr
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.input_specs import (batch_specs, cache_specs,
                                            params_specs)
from repro_torch.launch.roofline import model_flops
from repro_torch.models.model import build_model
from repro_torch.utils.tree import keystr_path, tree_leaves_with_path

KEY = jax.random.PRNGKey(0)
MESHES = ("pod16x16", "pod2x16x16")
METHODS = ("none", "sparse_gd", "dgc", "lgc_ps", "lgc_rar", "lgc_rar_q8")
VISION = "llama-3.2-vision-90b"


# -- the port's named dtypes --------------------------------------------------

def _port_dtype(cfg, where, path, leaf) -> str:
    """The dtype the port gives a reference leaf: token ids int64,
    encoder embeddings f32, the cross cache f32, else the reference's."""
    last = path.split("/")[-1]
    if where == "batch" and last in ("tokens", "labels"):
        return "int64"
    if where == "batch" and last == "encoder_embeds":
        return "float32"
    if where == "cache" and \
            cfg.block_pattern[int(path.split("/")[0][1:])] == "cross":
        return "float32"
    return str(leaf.dtype)


def _port_itemsize(cfg, where, path, leaf) -> int:
    return jnp.dtype(_port_dtype(cfg, where, path, leaf)).itemsize


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ours(tree):
    return [(keystr_path(p), tuple(x.shape), _dtype_name(x.dtype))
            for p, x in tree_leaves_with_path(tree)]


def _theirs(cfg, where, tree):
    return [(ref_keystr(p), tuple(x.shape),
             _port_dtype(cfg, where, ref_keystr(p), x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_input_specs_match_reference_eval_shape():
    named = set()
    for arch in ASSIGNED_ARCHS:
        cfg, rcfg = get_arch(arch), ref_get_arch(arch)
        model, rmodel = build_model(cfg), RefModel(rcfg)
        assert _ours(params_specs(model)) == \
            _theirs(rcfg, "params", RI.params_specs(rmodel)), arch
        for name, shape in INPUT_SHAPES.items():
            rshape = REF_SHAPES[name]
            rcache = RI.cache_specs(rmodel, rshape)
            assert _ours(cache_specs(model, shape)) == \
                _theirs(rcfg, "cache", rcache), (arch, name)
            rbatch = RI.batch_specs(rcfg, rshape)
            assert _ours(batch_specs(cfg, shape)) == \
                _theirs(rcfg, "batch", rbatch), (arch, name)
            # the differences named above, and no other
            for where, tree in (("cache", rcache), ("batch", rbatch)):
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    path = ref_keystr(p)
                    if _port_dtype(rcfg, where, path, x) != str(x.dtype):
                        named.add((arch if where == "cache" else "*", where,
                                   path.split("/")[-1], str(x.dtype)))
    assert named == {("*", "batch", "tokens", "int32"),
                     ("*", "batch", "labels", "int32"),
                     ("*", "batch", "encoder_embeds", "bfloat16"),
                     (VISION, "cache", "k", "bfloat16"),
                     (VISION, "cache", "v", "bfloat16")}


# -- the reference's rules on the reference's shapes --------------------------

def _ref_mesh(mesh_name):
    multi = mesh_name == "pod2x16x16"
    names = ("pod", "data", "model") if multi else ("data", "model")
    return SimpleNamespace(axis_names=names, devices=np.empty(
        (2, 16, 16) if multi else (16, 16), np.int8))


def _ref_cfg(arch, shape_name):
    """The reference dry run's config, long_500k's substitution included."""
    cfg = ref_get_arch(arch)
    if shape_name == "long_500k" and cfg.n_heads > 0 \
            and cfg.sliding_window == 0 and cfg.family not in ("hybrid",) \
            and cfg.mla is None:
        cfg = dataclasses.replace(cfg, sliding_window=8192)
    return cfg


@functools.lru_cache(maxsize=None)
def _ref_params(cfg):
    return jax.eval_shape(RefModel(cfg).init, KEY)


@functools.lru_cache(maxsize=None)
def _ref_cache(cfg, shape_name):
    return RI.cache_specs(RefModel(cfg), REF_SHAPES[shape_name])


def _ref_bytes(cfg, where, tree, spec_tree, sizes):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, RS.P))
    assert len(leaves) == len(specs)
    return sum(math.prod(RS.local_shape(tuple(x.shape), s, sizes))
               * _port_itemsize(cfg, where, ref_keystr(p), x)
               for (p, x), s in zip(leaves, specs))


def _ref_per_device(arch, shape_name, mesh_name, method):
    """What each device holds in the reference's step of the shape's kind
    on the mesh: its builders' rules applied by hand (the builders
    themselves need the 512 devices)."""
    cfg = _ref_cfg(arch, shape_name)
    model = RefModel(cfg)
    shape = REF_SHAPES[shape_name]
    mesh = _ref_mesh(mesh_name)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    mp, dp, dp_axes = model_size_of(mesh), dp_size_of(mesh), dp_axes_of(mesh)
    p = _ref_params(cfg)
    out = dict.fromkeys(("params", "optimizer", "compressor", "batch",
                         "cache"), 0)
    batch = RI.batch_specs(cfg, shape)
    if shape.kind == "train":
        cc = RCC(method=method, sparsity=0.001)
        o = jax.eval_shape(ref_build_optimizer(
            RTC(optimizer="adamw", compression=cc)).init, p)
        if method == "none":
            n = sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(p))
            fsdp = n > 2e9
            kw = dict(model_size=mp,
                      fsdp_axes=("data",) if fsdp else (),
                      fsdp_size=sizes["data"] if fsdp else 1)
        else:
            kw = dict(model_size=mp)
            pspecs = RS.param_pspecs(p, model_size=mp)
            flat, treedef = jax.tree_util.tree_flatten(p)
            template = treedef.unflatten([
                jax.ShapeDtypeStruct(RS.local_shape(
                    tuple(x.shape), s, {"model": mp}), x.dtype)
                for x, s in zip(flat, jax.tree_util.tree_leaves(
                    pspecs, is_leaf=lambda x: isinstance(x, RS.P)))])
            comp = ref_build_compressor(cc, template, dp)
            n_local = comp.layout.n_total
            dp_tuple = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            out["compressor"] = 2 * 4 * math.prod(RS.local_shape(
                (dp, mp, n_local), RS.P(dp_tuple, "model", None), sizes))
            state = jax.eval_shape(comp.init_state, KEY)
            for k in ("ae", "ae_mom"):
                if k in state:
                    out["compressor"] += sum(
                        math.prod(x.shape) * jnp.dtype(x.dtype).itemsize
                        for x in jax.tree_util.tree_leaves(state[k]))
        out["params"] = _ref_bytes(cfg, "params", p,
                                   RS.param_pspecs(p, **kw), sizes)
        out["optimizer"] = _ref_bytes(cfg, "params", o,
                                      RS.param_pspecs(o, **kw), sizes)
        out["batch"] = _ref_bytes(cfg, "batch", batch, RSteps._batch_pspecs(
            batch, dp_axes), sizes)
    else:
        out["params"] = _ref_bytes(cfg, "params", p,
                                   RSteps._serve_pspecs(model, mesh), sizes)
        cache = _ref_cache(cfg, shape_name)
        out["cache"] = _ref_bytes(cfg, "cache", cache, RS.cache_pspecs(
            cache, dp_axes=dp_axes, dp_size=dp, model_size=mp,
            seq_shard_axis="data" if dp > 1 else None), sizes)
        if shape.kind == "prefill":
            bspecs = RSteps._batch_pspecs(batch, dp_axes)
        else:
            B = shape.global_batch
            tok = RS.P(RS.batch_pspec(dp_axes)[0]
                       if B % dp == 0 and B > 1 else None)
            batch, bspecs = {"tokens": batch["tokens"]}, \
                {"tokens": RS.P(*tok, None)}
        out["batch"] = _ref_bytes(cfg, "batch", batch, bspecs, sizes)
    out["total"] = sum(out.values())
    return out


@pytest.fixture
def cached_ref_params(monkeypatch):
    """The reference's ``_serve_pspecs`` reads its params by eval_shape
    on every call: memoised by config here."""
    monkeypatch.setattr(RSteps, "params_specs",
                        lambda model: _ref_params(model.cfg))


def _run(tmp_path, arch, shape, mesh_name, method):
    argv = ["--arch", arch, "--shape", shape, "--compression", method,
            "--out", str(tmp_path)]
    if mesh_name == "pod2x16x16":
        argv.append("--multi-pod")
    return dryrun.run_one(dryrun.parse_args(argv))


@pytest.mark.parametrize("method", ("none", "lgc_rar"))
def test_per_device_bytes_match_reference_rules(tmp_path, cached_ref_params,
                                                method):
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            for mesh_name in MESHES:
                rec = _run(tmp_path, arch, shape, mesh_name, method)
                assert rec["per_device_bytes"] == _ref_per_device(
                    arch, shape, mesh_name, method), (arch, shape,
                                                      mesh_name)
                assert rec["chips"] == (512 if mesh_name == "pod2x16x16"
                                        else 256)


def test_per_device_bytes_of_every_method(tmp_path, cached_ref_params):
    totals = {}
    for method in METHODS:
        for mesh_name in MESHES:
            rec = _run(tmp_path, "llama3.2-1b", "train_4k", mesh_name,
                       method)
            assert rec["per_device_bytes"] == _ref_per_device(
                "llama3.2-1b", "train_4k", mesh_name, method), (method,
                                                                 mesh_name)
            totals[method, mesh_name] = rec["per_device_bytes"]
            assert ("n_local" in rec) == (method != "none")
    # the sparse methods hold u, v; the lgc methods the AE too; lgc_ps
    # one decoder a node (K = 16 or 32 of them)
    comp = {m: totals[m, "pod16x16"]["compressor"] for m in METHODS}
    assert comp["none"] == 0 and comp["sparse_gd"] == comp["dgc"] > 0
    assert comp["dgc"] < comp["lgc_rar"] == comp["lgc_rar_q8"] \
        < comp["lgc_ps"] < totals["lgc_ps", "pod2x16x16"]["compressor"]


def test_model_flops_match_reference(tmp_path):
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            rec = _run(tmp_path, arch, shape, "pod16x16", "none")
            ref = RR.model_flops(rec, ref_get_arch(arch))
            assert abs(rec["model_flops"] - ref) <= 1e-12 * ref, (arch,
                                                                  shape)
            assert rec["model_flops"] == model_flops(rec, get_arch(arch))


def test_long_500k_substitution(tmp_path):
    for arch in ASSIGNED_ARCHS:
        rec = _run(tmp_path, arch, "long_500k", "pod16x16", "none")
        want = _ref_cfg(arch, "long_500k") != ref_get_arch(arch)
        assert rec["sliding_window_substitution"] == want, arch
    # a substituted arch's cache holds the 8192-slot window, not 524288
    rec = _run(tmp_path, "llama3.2-1b", "long_500k", "pod16x16", "none")
    cfg = get_arch("llama3.2-1b")
    kv = 2 * cfg.n_layers * 8192 * cfg.n_kv_heads * cfg.head_dim * 2 // 16
    ring = cfg.n_layers * 8192 * 4 // 16
    assert rec["sliding_window_substitution"]
    assert rec["per_device_bytes"]["cache"] == kv + ring


def test_result_paths_and_all_writes_80_records(tmp_path):
    assert dryrun._result_path("d", "llama3.2-1b", "train_4k", "pod16x16",
                               "none") == os.path.join(
        "d", "llama3.2-1b__train_4k__pod16x16.json")
    assert dryrun._result_path("d", "qwen2-1.5b", "decode_32k",
                               "pod2x16x16", "lgc_rar") == os.path.join(
        "d", "qwen2-1.5b__decode_32k__pod2x16x16__lgc_rar.json")
    out = tmp_path / "all"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    names = sorted(os.listdir(out))
    assert len(names) == 80
    assert names == sorted(
        f"{a}__{s}__{m}.json" for a in ASSIGNED_ARCHS for s in INPUT_SHAPES
        for m in MESHES)
    with open(out / "llama3.2-1b__train_4k__pod16x16.json") as f:
        rec = json.load(f)
    assert set(rec) >= {"arch", "shape", "mesh", "chips", "compression",
                        "n_params", "param_bytes", "kind", "seq_len",
                        "global_batch", "sliding_window_substitution",
                        "per_device_bytes", "model_flops",
                        "active_param_fraction"}
    assert rec["n_params"] == build_model(get_arch("llama3.2-1b")) \
        .param_count()
    # a second --all skips what exists, as the reference's does
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    assert len(os.listdir(out)) == 80
