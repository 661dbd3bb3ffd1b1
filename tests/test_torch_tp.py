"""``--model-shards``: tensor parallelism over ``model`` and FSDP over
``data`` for the dense decoder, one process a shard, held to the
reference's own runs on 4 host devices at ``reduced()`` llama3.2-1b.

One launch (tests/_torch_tp_worker.py: world 4, data 2 x model 2, gloo)
runs every path in one process set, from the reference's initial weights
and AE (``reference_hier_init``: PRNGKey(0), as its trainer and server
draw them), while the reference's CLIs run once beside it in two
subprocesses (its trainer's auto step and lgc_rar on (2, 2); its server
at batch 4 on (2, 2) and at batch 1 on (data 2)):

- the auto step (``--compression none``, 3 steps): losses within 1e-5,
  the gathered final params within 2e-5 of their largest value (AdamW
  on rounding-sized gradient differences), the first step's gradient
  blocks within 1e-5 (of the largest) of the one-process port's
  gradient cut by the spec;
- lgc_rar through its three phases (4 steps): losses within 1e-5, each
  phase's wire bytes per node per op kind equal to the reference's
  logged rows, params, and each process's u and v against the
  reference's ``comp_state`` [d, m] block within 2e-5 of the largest;
- serving: greedy tokens equal to the reference's and to one process's
  at batch 4 (the batch over data, the heads over model), at batch 1
  (the cache split along the sequence over data), and at batch 4 with
  the weights also over data (``SERVE_FSDP_BYTES`` forced to 0); the
  last decode step's logits within 1e-5 of one process's;
- each process's held bytes equal to ``launch.dryrun``'s prediction for
  the mesh, but for one difference it names: at batch 4 the reference's
  rule splits the (n_blocks, S) position ring's S over data (it reads
  dim 1 as the batch), while every process here holds the whole ring;
- checkpoints of the sharded runs, one file a rank: the auto step and
  lgc_rar stopped after step 1 and resumed from their rank files, each
  rank's losses and final state (params and optimizer blocks, u, v, AE)
  bit for bit the uninterrupted run's, each file holding what its rank
  writes; lgc_rar's own rank files stitched into the reference's
  gathered layout hold its keys, shapes and dtypes, the values within
  2e-5 of the reference's file, and model shard 1's copy of a leaf whole
  over ``model`` is not model shard 0's;
- the reference's own files (the auto step's and lgc_rar's) cut into
  each rank's blocks (``load_gathered_checkpoint``), saved as rank files
  and stitched: the file again, key by key, bit for bit.

Without a launch: ``shard_tree`` and ``gather_tree`` inverse (threads
standing in for the processes), the GQA grouping under a shard of the
heads, the other block kinds' blocks under 2 model shards (their
sharded runs are tests/test_torch_tp_kinds.py's), what is refused, and
a mesh that splits a kv head (threads standing in for 8 shards; the
launches of such meshes are tests/test_torch_tp_heads.py's).
"""
import ast
import json
import os
import re
import subprocess
import sys
import threading
from functools import lru_cache

import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_pg import REPO, launch, worker
from _torch_tp_threads import shards_and_one_process
from _torch_train_common import close, reference_hier_init
from repro_torch.checkpoint import (load_gathered_checkpoint, rank_path,
                                    save_rank_checkpoint,
                                    stitch_rank_checkpoints)
from repro_torch.checkpoint.checkpoint import writes
from repro_torch.configs import get_arch
from repro_torch.configs.base import (CompressionConfig, InputShape,
                                      TrainConfig)
from repro_torch.data import synthetic_token_batches
from repro_torch.dist import sharding as SH
from repro_torch.dist.tp import Shards
from repro_torch.launch import dryrun, serve, steps, train
from repro_torch.launch.input_specs import params_specs
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import build_optimizer
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path, tree_unflatten)

CFG = get_arch("llama3.2-1b").reduced()
MESH = host_mesh(2, 2)
COORDS = [{"data": r // 2, "model": r % 2} for r in range(4)]

REF_TRAIN = """
import json, sys
from repro.launch import train
auto, lgc = json.loads(sys.argv[1])
train.main(auto + ["--metrics-out", "auto.json", "--checkpoint-dir", "auto"])
train.main(lgc + ["--metrics-out", "lgc.json", "--checkpoint-dir", "lgc"])
"""
REF_SERVE = """
import json, sys
from repro.launch import serve
out = {name: serve.main(flags).tolist()
       for name, flags in json.loads(sys.argv[1]).items()}
json.dump(out, open("serve.json", "w"))
"""


@lru_cache(maxsize=1)
def _init():
    return reference_hier_init()


def _full():
    return W.whole_params(CFG, [v for k, v in sorted(
        _init().items(), key=lambda kv: int(kv[0][1:])) if k[0] == "p"])


def _reference(tmp, name, code, arg):
    """The reference's CLIs in a subprocess, their log tmp/<name>.log."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)        # the CLIs ask for their devices
    log = open(tmp / f"{name}.log", "w")
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(arg)],
                            cwd=str(tmp), env=env, stdout=log,
                            stderr=subprocess.STDOUT), log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    np.savez(tmp / "init.npz", **_init())
    refs = [_reference(tmp, "train", REF_TRAIN, [W.AUTO, W.LGC]),
            _reference(tmp, "serve", REF_SERVE, {"b4": W.SERVE_B4,
                                                 "b1": W.SERVE_B1})]
    try:
        launch(tmp, worker("_torch_tp_worker.py") + [
            str(tmp / "init.npz"), str(tmp / "out"), "{store}"], 4,
            timeout=240)
    finally:
        for p, log in refs:
            try:
                p.wait(timeout=240)
            finally:
                if p.poll() is None:
                    p.kill()
                log.close()
    for p, _ in refs:
        assert p.returncode == 0, (tmp / "train.log").read_text()[-3000:] \
            + (tmp / "serve.log").read_text()[-3000:]
    ranks = []
    for r in range(4):
        with open(tmp / "out" / f"rank{r}.json") as f:
            rec = json.load(f)
        rec["arrays"] = dict(np.load(tmp / "out" / f"rank{r}.npz"))
        ranks.append(rec)
    wire = {m.group(1): ast.literal_eval(m.group(2)) for m in re.finditer(
        r"phase=(\w+) wire bytes/node/step: (\{.*\})",
        (tmp / "train.log").read_text())}
    ref = {"wire": wire, "dir": tmp,
           "serve": json.loads((tmp / "serve.json").read_text())}
    for name in ("auto", "lgc"):
        ref[name] = [h["loss"] for h in json.loads(
            (tmp / f"{name}.json").read_text())]
        with np.load(tmp / name / "ckpt.npz") as z:
            ref[name + "_ckpt"] = {k: z[k] for k in z.files}
    return ranks, ref


def _batch():
    return train.to_device(next(synthetic_token_batches(
        CFG.vocab_size, W.BATCH, W.SEQ, seed=0)), "cpu")


def _grads(params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = build_model(CFG).loss(tree_unflatten(params, leaves), batch)
    return loss, tree_unflatten(params, torch.autograd.grad(loss, leaves))


def _hold_params(got, ckpt, what):
    """The gathered params (rank 0's p<i>) against the reference's saved
    ones, within 2e-5 of the largest value."""
    for i, (path, _) in enumerate(tree_leaves_with_path(_full())):
        close(got[f"p{i}"], ckpt["params/" + keystr_path(path)], 2e-5,
              f"{what} {keystr_path(path)}")


def _tc(method, optimizer="adamw"):
    return TrainConfig(optimizer=optimizer,
                       compression=CompressionConfig(method=method))


def _predicted(method):
    """``launch.dryrun``'s bytes a device holds for the step on MESH; its
    optimizer state is AdamW's, so the momentum SGD state these runs
    hold (one f32 tree) is priced by the same rules: the optimizer
    tree's leaves under the step's specs (``dryrun.local_bytes``)."""
    model = build_model(CFG)
    out, _ = dryrun.per_device_bytes(
        model, InputShape("t", W.SEQ, W.BATCH, "train"), MESH,
        compression=method, fsdp="on")
    tc = _tc(method, "sgd_momentum")
    o_shapes = build_optimizer(tc).init(params_specs(model))
    fsdp = ("data",) if method == "none" else ()
    out["optimizer"] = dryrun.local_bytes(o_shapes, SH.param_pspecs(
        o_shapes, model_size=2, fsdp_axes=fsdp, fsdp_size=2 if fsdp else 1),
        MESH.axis_sizes)
    return out


def test_auto_step_matches_reference(runs):
    ranks, ref = runs
    full = _full()
    loss, grads = _grads(full, _batch())
    pspecs = steps.auto_train_pspecs(build_model(CFG), _tc("none"), MESH)[0]
    want = _predicted("none")
    for r, rec in enumerate(ranks):
        losses = [h["loss"] for h in rec["auto"]["history"]]
        np.testing.assert_allclose(losses, ref["auto"], rtol=0, atol=1e-5,
                                   err_msg=f"rank {r}")
        assert [h["phase"] for h in rec["auto"]["history"]] == ["dense"] * 3
        # the first step: this process's gradient block, the global loss
        a = rec["arrays"]
        np.testing.assert_allclose(a["auto_loss"], loss.item(), rtol=0,
                                   atol=1e-5)
        block = SH.shard_tree(grads, pspecs, COORDS[r], MESH.axis_sizes)
        for i, (path, g) in enumerate(tree_leaves_with_path(block)):
            close(a[f"auto_g{i}"], g.numpy(), 1e-5,
                  f"rank {r} gradient {keystr_path(path)}")
        held = rec["auto"]["held"]
        assert (held["params"], held["optimizer"], held["compressor"]) == (
            want["params"], want["optimizer"], 0), (r, held, want)
    _hold_params({k[len("auto_"):]: v for k, v in ranks[0]["arrays"].items()
                  if k.startswith("auto_p")}, ref["auto_ckpt"], "auto")


def test_lgc_step_with_model_shards_matches_reference(runs):
    ranks, ref = runs
    full, batch = _full(), _batch()
    st = steps.lgc_state_specs(build_model(CFG),
                               CompressionConfig(method="lgc_rar"), MESH)
    want = _predicted("lgc_rar")
    for r, rec in enumerate(ranks):
        d, m = COORDS[r]["data"], COORDS[r]["model"]
        hist = rec["lgc"]["history"]
        np.testing.assert_allclose([h["loss"] for h in hist], ref["lgc"],
                                   rtol=0, atol=1e-5, err_msg=f"rank {r}")
        assert [h["phase"] for h in hist] == [
            "warmup", "topk_ae", "compressed", "compressed"]
        # each phase's bytes a node, per op kind: the reference's rows
        for phase, row in rec["lgc"]["wire"].items():
            kinds = {}
            for op in row.values():
                for kind, b in op.items():
                    kinds[kind] = kinds.get(kind, 0) + b
            assert kinds == ref["wire"][phase], (r, phase, kinds)
        # the first step: node d's gradient, model shard m's block, flat
        rows = {k: x[d * W.BATCH // 2:(d + 1) * W.BATCH // 2]
                for k, x in batch.items()}
        _, g = _grads(full, rows)
        block = SH.shard_tree(g, st.params, COORDS[r], MESH.axis_sizes)
        close(rec["arrays"]["lgc_g"], torch.cat(
            [x.reshape(-1) for x in tree_leaves(block)]).numpy(), 1e-5,
            f"rank {r} node gradient")
        # the EF accumulators of (node d, model shard m)
        for key in ("u", "v"):
            ours = rec["arrays"][key]
            theirs = ref["lgc_ckpt"][f"comp_state/{key}"][d, m]
            np.testing.assert_array_equal(ours == 0, theirs == 0,
                                          f"rank {r} cleared {key}")
            close(ours, theirs, 2e-5, f"rank {r} {key}")
        held = rec["lgc"]["held"]
        assert held == {k: want[k] for k in held}, (r, held, want)
    _hold_params({k[len("lgc_"):]: v for k, v in ranks[0]["arrays"].items()
                  if k.startswith("lgc_p")}, ref["lgc_ckpt"], "lgc")


def test_serving_matches_reference_and_one_device(runs, monkeypatch):
    ranks, ref = runs
    full = _full()
    for name, ref_name, B in (("b4", "b4", 4), ("b1", "b1", 1),
                              ("b4_fsdp", "b4", 4)):
        one = serve.run(CFG, serve.parse_args(
            W.SERVE + ["--batch", str(B), "--device", "cpu"]), params=full)
        assert one["tokens"].tolist() == ref["serve"][ref_name], name
        shape = InputShape("d", W.PROMPT + W.GEN, B, "decode")
        # the fsdp run's weights: the rule with its threshold at 0, as the
        # launch forced it
        monkeypatch.setattr(steps, "SERVE_FSDP_BYTES",
                            0 if name == "b4_fsdp" else 8e9)
        want, _ = dryrun.per_device_bytes(build_model(CFG), shape, MESH)
        ring = 4 * CFG.n_blocks * (W.PROMPT + W.GEN)     # int32 positions
        for r, rec in enumerate(ranks):
            assert rec[name]["tokens"] == ref["serve"][ref_name], (r, name)
            close(rec["arrays"][f"{name}_logits"], one["logits"], 1e-5,
                  f"rank {r} {name} logits")
            held = rec[name]["held"]
            # the batch over data: the whole position ring here, half of
            # it under the reference's rule
            extra = ring // 2 if B > 1 else 0
            assert held["cache"] == want["cache"] + extra, (r, name, held)
            assert held["params"] == want["params"], (r, name, held)


def _nested(flat):
    """{"a/b": x} -> {"a": {"b": x}}: a file's entries as the tree it was
    saved from (its keys again under ``keystr_path``)."""
    out = {}
    for key, x in flat.items():
        *head, last = key.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def _state_specs(name, tree):
    """{file key: spec} of the trainer's state ``tree`` on MESH."""
    model = build_model(CFG)
    pspecs = steps.auto_train_pspecs(model, _tc("none"), MESH)[0] \
        if name == "auto" else steps.lgc_state_specs(
            model, CompressionConfig(method="lgc_rar"), MESH).params
    return steps.train_state_specs(pspecs, tree, ("data",))


@pytest.mark.parametrize("name", ["auto", "lgc"])
def test_sharded_resume_is_bit_for_bit(runs, name):
    """Stopped after step 1 and resumed from the rank files: every rank's
    later losses and its own final params, optimizer state, u, v and AE
    are the uninterrupted run's, bit for bit; each rank's file holds the
    leaves it writes (0 on the dp axes a spec leaves whole) and the
    header."""
    ranks, ref = runs
    path = str(ref["dir"] / "out" / f"{name}_ckpt" / "ckpt.npz")
    for r, rec in enumerate(ranks):
        whole, resumed = rec[name], rec[f"{name} resumed"]
        assert [h["step"] for h in rec[f"{name} stopped"]["history"]] == [
            0, 1], r
        assert resumed["resumed"]["step"] == 2, r
        assert resumed["resumed"]["layout"] == "rank files", r
        assert [(h["step"], h["loss"]) for h in resumed["history"]] == [
            (h["step"], h["loss"]) for h in whole["history"][2:]], r
        assert resumed["state_leaf_digests"] == whole["state_leaf_digests"]
        assert resumed["state_digest"] == whole["state_digest"], r
        if name == "lgc":
            assert [h["phase"] for h in resumed["history"]] == [
                "compressed", "compressed"], r
        with np.load(rank_path(path, r)) as z:
            specs = {k: tuple(tuple(e) if isinstance(e, list) else e
                              for e in sp) for k, sp in json.loads(
                                  str(z["__specs__"])).items()}
            assert set(z.files) == {k for k, sp in specs.items()
                                    if writes(sp, COORDS[r])} | {
                "__step__", "__mesh__", "__node__", "__model__",
                "__specs__"}, r
            assert int(z["__step__"]) == 2 and z["__model__"].tolist() == [
                2, COORDS[r]["model"]], r
        assert specs == _state_specs(name, _nested(dict.fromkeys(specs, 0))), r


@pytest.mark.parametrize("name", ["auto", "lgc"])
def test_gathered_file_round_trip(runs, name, tmp_path):
    """The reference trainer's file: each of the four ranks' blocks as
    ``load_gathered_checkpoint`` cuts them are ``shard_tree``'s (u, v
    its [d, m] row), and the four saved as rank files and stitched are
    the file again, key by key, bit for bit."""
    _, ref = runs
    path = str(ref["dir"] / name / "ckpt.npz")
    arrays = ref[f"{name}_ckpt"]
    step = int(arrays["__step__"])
    whole = _nested({k: torch.from_numpy(x) for k, x in arrays.items()
                     if k != "__step__"})
    specs = _state_specs(name, whole)
    out = str(tmp_path / "ckpt.npz")
    for r, c in enumerate(COORDS):
        want = SH.shard_tree(whole, specs, c, MESH.axis_sizes)
        got, got_step = load_gathered_checkpoint(path, want, specs, c,
                                                 MESH.axis_sizes)
        assert got_step == step
        for (p, a), b in zip(tree_leaves_with_path(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (
                r, keystr_path(p))
        if name == "lgc":
            for key in ("u", "v"):
                assert torch.equal(got["comp_state"][key][0, 0],
                                   torch.from_numpy(arrays[
                                       f"comp_state/{key}"][c["data"],
                                                            c["model"]]))
        save_rank_checkpoint(out, got, step, (2,), c["data"], 2, c["model"],
                             specs)
    stitch_rank_checkpoints(out, str(tmp_path / "stitched.npz"))
    with np.load(tmp_path / "stitched.npz") as z:
        assert set(z.files) == set(arrays)
        for key, x in arrays.items():
            y = z[key]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), key
            assert x.tobytes() == y.tobytes(), key


def test_port_rank_files_stitch_to_reference(runs, tmp_path):
    """lgc_rar's rank files at its end, stitched: the reference's file's
    keys, shapes and dtypes, every value within 2e-5 of the largest of
    the reference's: of its own array for the params, the optimizer state,
    u and v (the gate of the u, v and params above), of the AE's largest
    entry for the AE, and for the AE's momentum of the step it makes on
    the AE (ae_lr times it): the encoder biases' entries of the last AE
    gradient are sums over every position that cancel far below their
    terms, and f32's order leaves them up to 0.41 of their own largest
    apart.  And the finding the rank files keep: model shard 1's copy of
    a leaf whole over ``model`` differs from model shard 0's."""
    _, ref = runs
    path = str(ref["dir"] / "out" / "lgc_final" / "ckpt.npz")
    stitch_rank_checkpoints(path, str(tmp_path / "stitched.npz"))
    theirs = ref["lgc_ckpt"]
    with np.load(tmp_path / "stitched.npz") as z:
        ours = {k: z[k] for k in z.files}
    assert set(ours) == set(theirs)
    assert int(ours["__step__"]) == int(theirs["__step__"]) == 4
    ae = max(float(np.abs(x).max()) for k, x in theirs.items()
             if k.startswith("comp_state/ae/"))
    for key, x in theirs.items():
        assert (x.dtype, x.shape) == (ours[key].dtype, ours[key].shape), key
        scale = ae if key.startswith("comp_state/ae/") else \
            ae / CompressionConfig().ae_lr \
            if key.startswith("comp_state/ae_mom/") else \
            max(float(np.abs(x).max()), 1e-30)
        np.testing.assert_allclose(ours[key], x, rtol=0, atol=2e-5 * scale,
                                   err_msg=key)
    specs = _state_specs("lgc", _nested(
        {k: 0 for k in theirs if k != "__step__"}))
    with np.load(rank_path(path, 0)) as m0, np.load(rank_path(path, 1)) as m1:
        whole = [k for k, sp in specs.items() if k.startswith("params/")
                 and "model" not in SH.spec_axes(sp)]
        differ = [k for k in whole if not np.array_equal(m0[k], m1[k])]
    assert whole and differ, whole


class _Threads:
    """Threads standing in for the processes of ``mesh``: each axis line
    a group whose ``all_gather`` swaps blocks through a barrier."""

    def __init__(self, mesh):
        self.mesh, self.boards = mesh, {}
        self.coords = [dict(zip(mesh.axis_names, (int(c) for c in
                                                  np.unravel_index(r,
                                                                   mesh.shape))))
                       for r in range(mesh.size)]
        for c in self.coords:
            for a in mesh.axis_names:
                key = (a,) + tuple(v for b, v in c.items() if b != a)
                n = mesh.axis_sizes[a]
                self.boards.setdefault(key, (threading.Barrier(n), [None] * n))

    def groups(self, c):
        out = {}
        for a in self.mesh.axis_names:
            barrier, slots = self.boards[(a,) + tuple(
                v for b, v in c.items() if b != a)]

            class G:
                def all_gather(self, x, dim, i=c[a], slots=slots,
                               barrier=barrier):
                    slots[i] = x
                    barrier.wait()
                    y = torch.cat(list(slots), dim)
                    barrier.wait()
                    return y
            out[a] = G()
        return out


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4)])
def test_shard_and_gather_are_inverse(data, model):
    """The reference's numpy weights carried across as each process's
    block (``params_from_numpy`` with a spec), then gathered: the
    unsharded conversion, bit for bit; every block a strict part."""
    mesh = host_mesh(data, model)
    specs = steps.auto_train_pspecs(build_model(CFG), _tc("none"), mesh)[0]
    numpy_full = tree_unflatten(_full(), [v for k, v in sorted(
        _init().items(), key=lambda kv: int(kv[0][1:])) if k[0] == "p"])
    whole = params_from_numpy(numpy_full)
    threads, out = _Threads(mesh), [None] * mesh.size

    def rank(r):
        c = threads.coords[r]
        local = params_from_numpy(numpy_full, specs=specs, coords=c,
                                  sizes=mesh.axis_sizes)
        out[r] = (local, SH.gather_tree(local, specs, threads.groups(c)))
    ts = [threading.Thread(target=rank, args=(r,)) for r in range(mesh.size)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    for local, back in out:
        assert sum(x.numel() for x in tree_leaves(local)) < sum(
            x.numel() for x in tree_leaves(whole))
        for a, b in zip(tree_leaves(back), tree_leaves(whole)):
            assert a.dtype == b.dtype and torch.equal(a, b)


class _Stub:
    """The model group of ``mp`` shards, seen from shard ``m`` alone:
    the collectives left out, so each shard's output is its part."""

    def __init__(self, mp, m=0):
        self.size, self.index = mp, m


def test_gqa_heads_meet_their_kv_heads_under_a_shard():
    """A shard of wq holding query heads [m·H/mp, (m+1)·H/mp) with the
    kv heads [m·KH/mp, ...) of its own wk, wv shards: the shards'
    row-parallel parts sum to the whole attention's output, at 2 and 4
    shards."""
    g = torch.Generator().manual_seed(0)
    p = L.init_attention(g, CFG, torch.float32, "cpu")
    x = torch.randn(2, 8, CFG.d_model, generator=g)
    pos = torch.arange(8)
    whole = L.attention_fwd(p, CFG, x, pos)[0] - x
    for mp in (2, 4):
        specs = SH.param_pspecs(p, model_size=mp)
        parts = 0
        for m in range(mp):
            local = SH.shard_tree(p, specs, {"model": m}, {"model": mp})
            tp = Shards(model=_Stub(mp, m), specs=specs)
            tp.copy = tp.reduce = lambda t: t
            parts = parts + (L.attention_fwd(local, CFG, x, pos, tp)[0] - x)
        close(parts.detach().numpy(), whole.detach().numpy(), 1e-5,
              f"GQA over {mp} shards")


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_model_shards_outside_torchrun_raises(entry):
    mod = train if entry == "train" else serve
    with pytest.raises(ValueError, match="torchrun"):
        mod.run(CFG, mod.parse_args(["--smoke", "--model-shards", "2",
                                     "--device", "cpu"]))


@pytest.mark.parametrize("arch", ["arctic-480b", "mamba2-130m",
                                  "deepseek-v3-671b",
                                  "llama-3.2-vision-90b"])
def test_other_block_kinds_hold_the_dry_runs_blocks(arch):
    """MoE, Mamba2, MLA (with MTP) and cross-attention under 2 model
    shards: the model builds, and its params drawn on the meta device and
    cut by the LGC step's specs are each shard's block of the dry run's
    placement (``lgc_state_specs``' per-shard template, whose bytes
    ``launch.dryrun`` prices), every leaf the spec splits halved."""
    cfg = get_arch(arch).reduced()
    model = Model(cfg, Shards(model=_Stub(2)))
    full = model.init(torch.Generator(), "meta")
    st = steps.lgc_state_specs(build_model(cfg),
                               CompressionConfig(method="lgc_rar"),
                               host_mesh(1, 2))
    want, _ = dryrun.per_device_bytes(
        build_model(cfg), InputShape("t", 32, 2, "train"), host_mesh(1, 2),
        compression="lgc_rar")
    held = 0
    for m in range(2):
        local = SH.shard_tree(full, st.params, {"model": m}, {"model": 2})
        for (path, x), t, w in zip(tree_leaves_with_path(local),
                                   tree_leaves(st.template),
                                   tree_leaves(full)):
            assert x.shape == t.shape, (keystr_path(path), x.shape)
            split = "model" in st.params[keystr_path(path)]
            assert x.numel() * (2 if split else 1) == w.numel()
        held = sum(x.numel() * x.element_size() for x in tree_leaves(local))
        assert held == want["params"], (m, held, want)
    assert any("model" in sp for sp in st.params.values())


def test_a_mesh_that_splits_a_head_raises():
    """Once refused, now run: 8 query and 4 kv heads over 8 shards, half
    a kv head each, as the reference's GSPMD splits the flattened heads x
    head_dim.  Threads standing in for the 8 shards: each shard's loss,
    prefill and decode logits equal one process's within 1e-5, its
    gradient blocks within 1e-5 of each leaf's largest entry, and its
    cache holds all 4 kv heads (the reference's cache rule replicates a
    dim the model axis does not divide)."""
    g = torch.Generator().manual_seed(0)
    full = build_model(CFG).init(g)
    tokens = torch.randint(0, CFG.vocab_size, (2, 16), generator=g)
    got, want = shards_and_one_process(
        CFG, 8, full, {"tokens": tokens, "labels": tokens.roll(-1, 1)})
    for m, res in enumerate(got):
        np.testing.assert_allclose(float(res["loss"]), float(want["loss"]),
                                   rtol=0, atol=1e-5)
        for key in ("logits", "step"):
            close(res[key].numpy(), want[key].numpy(), 1e-5, f"{m} {key}")
        for a, b in zip(res["grads"], want["grads"][m]):
            close(a.numpy(), b.numpy(), 1e-5, f"shard {m} gradient")
        assert res["cache"]["p0"]["k"].shape[3] == CFG.n_kv_heads == 4
