"""Dry run on the meta device (counterpart of ``repro.launch.dryrun``):
for any arch x input shape x production mesh, what each device would
hold under the reference's placement rules, allocating nothing.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod | --both-meshes] \\
        [--compression lgc_rar] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 80 records

Each record (one JSON file, named as the reference names it) keeps the
reference's fields ``arch``, ``shape``, ``mesh``, ``chips``,
``compression``, ``n_params``, ``param_bytes``, ``kind``, ``seq_len``,
``global_batch`` and ``sliding_window_substitution``, and adds what the
rules state exactly: ``per_device_bytes`` (params, optimizer state,
compressor state ``u``, ``v``, ``ae``, ``ae_mom``, batch, and cache:
decode's input, prefill's output; and their total), ``n_local`` (one
model shard's gradient length, for a compressed method), ``fsdp`` (the
auto step's choice), ``model_flops`` and ``active_param_fraction``
(``launch.roofline``).  The step's specs are ``launch.steps``'s rule
functions on a ``launch.mesh.MeshSpec``; shapes and dtypes are
``launch.input_specs``'s meta tensors.  A pure full-attention arch
(neither hybrid nor MLA) runs long_500k with ``sliding_window=8192``, as
in the reference, and its record says so.

Nothing is compiled, so ``--all`` runs every combination in this
process, and the record has none of the reference's XLA analyses: no
``memory_analysis`` (the step's temporaries), no ``cost_analysis``, no
collective bytes and no loop-aware HLO walk.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_arch
from repro_torch.configs.base import (CompressionConfig, InputShape,
                                      TrainConfig)
from repro_torch.dist.sharding import local_shape
from repro_torch.launch import steps as ST
from repro_torch.launch.input_specs import (batch_specs, cache_specs,
                                            params_specs)
from repro_torch.launch.mesh import MeshSpec, dp_axes_of, production_mesh
from repro_torch.launch.roofline import active_param_fraction, model_flops
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import build_optimizer
from repro_torch.utils.tree import (keystr_path, tree_count_params,
                                    tree_leaves_with_path, tree_size_bytes)

log = logging.getLogger("repro_torch.dryrun")

FSDP_AUTO_PARAMS = 2e9          # --fsdp auto shards the auto step above
LONG_WINDOW = 8192              # long_500k's sliding-window substitution


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--compression", default="none")
    p.add_argument("--sparsity", type=float, default=0.001)
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--all", action="store_true",
                   help="every (arch x shape) on both meshes")
    p.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    return p.parse_args(argv)


def _result_path(out_dir, arch, shape, mesh_name, compression):
    tag = f"{arch}__{shape}__{mesh_name}"
    if compression != "none":
        tag += f"__{compression}"
    return os.path.join(out_dir, tag + ".json")


def local_bytes(tree: Any, specs: Optional[Dict[str, tuple]],
                axis_sizes: Dict[str, int]) -> int:
    """One device's bytes of ``tree`` under {path: spec} (None: the whole
    tree replicated)."""
    total = 0
    for path, leaf in tree_leaves_with_path(tree):
        spec = specs[keystr_path(path)] if specs is not None else ()
        total += math.prod(local_shape(tuple(leaf.shape), spec,
                                       axis_sizes)) * leaf.element_size()
    return total


def per_device_bytes(model: Model, shape: InputShape, mesh: MeshSpec,
                     compression: str = "none", sparsity: float = 0.001,
                     fsdp: str = "auto"):
    """({params, optimizer, compressor, batch, cache, total}: bytes a
    device holds, {"n_local"} or {"fsdp"}) for the reference's step of
    ``shape.kind`` on ``mesh``: the auto step (``compression`` "none";
    AdamW) or the LGC step for training, the serving weights with the
    cache for prefill and decode."""
    cfg, sizes = model.cfg, mesh.axis_sizes
    p_shapes = params_specs(model)
    batch = batch_specs(cfg, shape)
    out = dict.fromkeys(("params", "optimizer", "compressor", "batch",
                         "cache"), 0)
    extra: Dict[str, Any] = {}
    if shape.kind == "train":
        cc = CompressionConfig(method=compression, sparsity=sparsity)
        tc = TrainConfig(optimizer="adamw", compression=cc)
        o_shapes = build_optimizer(tc).init(p_shapes)
        if compression == "none":
            on = (fsdp == "on") if fsdp != "auto" else \
                tree_count_params(p_shapes) > FSDP_AUTO_PARAMS
            pspecs, ospecs = ST.auto_train_pspecs(model, tc, mesh, fsdp=on)
            extra["fsdp"] = on
        else:
            st = ST.lgc_state_specs(model, cc, mesh)
            pspecs, ospecs = st.params, st.optimizer
            # u and v: (dp, mp, n_local) f32 rows, and the replicated AE
            base = st.compressor.init_state(torch.Generator(), "meta")
            out["compressor"] = 2 * 4 * math.prod(local_shape(
                (st.dp, st.mp, st.n_local), st.comp["u"], sizes)) + sum(
                local_bytes(base[k], None, sizes)
                for k in ("ae", "ae_mom") if k in st.comp)
            extra["n_local"] = st.n_local
        out["optimizer"] = local_bytes(o_shapes, ospecs, sizes)
        out["batch"] = local_bytes(
            batch, ST.batch_pspecs(batch, dp_axes_of(mesh)), sizes)
    else:
        pspecs = ST.serve_pspecs(model, mesh)
        cache = cache_specs(model, shape)
        out["cache"] = local_bytes(cache, ST.serve_cache_pspecs(cache, mesh),
                                   sizes)
        if shape.kind == "prefill":
            bspecs = ST.batch_pspecs(batch, dp_axes_of(mesh))
        else:
            bspecs = {"tokens": ST.decode_token_pspec(shape, mesh)}
        out["batch"] = local_bytes(batch, bspecs, sizes)
    out["params"] = local_bytes(p_shapes, pspecs, sizes)
    out["total"] = sum(out.values())
    return out, extra


def run_one(args) -> dict:
    base_cfg = get_arch(args.arch)
    cfg = base_cfg
    shape = INPUT_SHAPES[args.shape]
    window_sub = False
    if shape.name == "long_500k" and cfg.n_heads > 0 \
            and cfg.sliding_window == 0 and cfg.family not in ("hybrid",) \
            and cfg.mla is None:
        # the sub-quadratic variant for pure full-attention archs; hybrid
        # (few attention layers) and MLA (a latent cache) run it natively
        cfg = dataclasses.replace(cfg, sliding_window=LONG_WINDOW)
        window_sub = True
    mesh = production_mesh(multi_pod=args.multi_pod)
    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    model = build_model(cfg)
    p_shapes = params_specs(model)
    n_params = tree_count_params(p_shapes)
    t0 = time.perf_counter()
    pdb, extra = per_device_bytes(model, shape, mesh, args.compression,
                                  args.sparsity, args.fsdp)
    result = {
        "arch": args.arch,
        "shape": args.shape,
        "mesh": mesh_name,
        "chips": mesh.size,
        "compression": args.compression,
        "n_params": n_params,
        "param_bytes": tree_size_bytes(p_shapes),
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "sliding_window_substitution": window_sub,
        "per_device_bytes": pdb,
        **extra,
    }
    result["active_param_fraction"] = active_param_fraction(base_cfg)
    result["model_flops"] = model_flops(result, base_cfg)
    os.makedirs(args.out, exist_ok=True)
    path = _result_path(args.out, args.arch, args.shape, mesh_name,
                        args.compression)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    log.info("%s x %s on %s (%.2fB params): %.3f GB a device; wrote %s "
             "(%.2fs)", args.arch, args.shape, mesh_name, n_params / 1e9,
             pdb["total"] / 1e9, path, time.perf_counter() - t0)
    return result


def run_all(args):
    """Every (arch x shape) on both meshes, in this process; a
    combination whose file exists is skipped, one that fails is listed
    and the others still run.  Returns the failures."""
    failures = []
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            for multi_pod in (False, True):
                path = _result_path(args.out, arch, shape,
                                    "pod2x16x16" if multi_pod else "pod16x16",
                                    args.compression)
                if os.path.exists(path):
                    print("skip (exists):", path)
                    continue
                one = copy.copy(args)
                one.arch, one.shape, one.multi_pod = arch, shape, multi_pod
                try:
                    run_one(one)
                except Exception:           # listed; the rest still run
                    failures.append((arch, shape, multi_pod))
                    print("FAILED:", traceback.format_exc()[-2000:],
                          flush=True)
    print(f"\n{'=' * 60}\nfailures: {len(failures)}")
    for f in failures:
        print("  ", f)
    return failures


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    if args.all:
        return 1 if run_all(args) else 0
    if args.both_meshes:
        for mp in (False, True):
            args.multi_pod = mp
            run_one(args)
        return 0
    run_one(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
