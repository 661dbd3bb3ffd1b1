"""``--model-shards`` on meshes whose model axis cuts a head, as the
reference runs them (its rules split the flattened heads x head_dim
columns however the model axis divides them): kv heads, query heads,
Mamba2 heads and cross-attention's kv heads cut mid-head, one process a
shard, held to the reference's trainer and server on 4 host devices.

The cases (tests/_torch_tp_heads_worker.py ``CASES``), at ``reduced()``
widths or an override of them, each on (data 1, model 4) but one:
qwen2-1.5b (8 query and 2 kv heads: half a kv head a shard), 6 query and
3 kv heads (1.5 query and 0.75 kv heads a shard; and on (data 2, model
2), 1.5 kv heads), mamba2-130m with 6 Mamba2 heads (1.5 a shard), and
llama-3.2-vision-90b with 2 kv heads (half a kv head a shard in self- and
cross-attention; the cross gates at 0.5 in both packages, so that the
cross layers count).

One launch (world 4, gloo) runs every case from the reference's initial
weights and AE (PRNGKey(0), drawn here), while one subprocess runs the
reference's trainer and server beside it, with the same overrides and
gates; and deepseek-v3-671b with 6 latent-attention heads over model 4
(``THREAD_CASES``: its auto step and serving in the reference
subprocess, the port's on threads standing in for the ranks, no
process launch).  Gates, as tests/test_torch_tp.py's:

- the auto step (``--compression none``, 3 steps): losses within 1e-5 of
  the reference's; the first step's gradient blocks within 1e-5 of each
  leaf's largest entry (5e-5 through Mamba2 blocks, f32's floor there:
  tests/_torch_arch_checks.py) of the one-process port's gradient cut by
  the spec; held bytes the dry run's;
- lgc_rar through its three phases (on qwen2, the (data 2, model 2)
  case and mamba2; the 6 query / 3 kv heads on (data 1, model 4) and
  vision are held by their auto step's gradients and their serving):
  losses within 1e-5, each phase's
  wire bytes per op kind the reference's logged rows (none where one
  node, at data 1, exchanges nothing), the cleared
  entries of u and v those of the reference's ``comp_state`` [d, m], u,
  v and the gathered params within 2e-5 of the largest (5e-5 for the
  Mamba2 case), with momentum SGD; held bytes the dry run's;
- serving: greedy tokens equal to the reference's at batch 4 and, on
  (data 2, model 2), at batch 1 with the cache split along the sequence
  (the reference's B1 on (data 2)); the last logits within 1e-5 of one
  process's; held bytes the dry run's (but the (n_blocks, S) position
  ring at batch 4 over data 2: the reference's rule splits its S, every
  process here holds it whole, tests/test_torch_tp.py says why);
- deepseek's cut latent heads: the auto step's losses within 1e-5 of
  the reference's, greedy tokens at batch 4 the reference's.
"""
import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_tp_heads_worker as W
import _torch_tp_worker as TW
from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_pg import REPO, launch, worker
from _torch_tp_threads import run_ranks, thread_grids
from _torch_train_common import close
from repro_torch.configs import get_arch
from repro_torch.configs.base import (CompressionConfig, InputShape,
                                      TrainConfig)
from repro_torch.data import synthetic_token_batches
from repro_torch.dist import sharding as SH
from repro_torch.dist.tp import Shards
from repro_torch.launch import dryrun, serve, steps, train
from repro_torch.launch.input_specs import params_specs
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import mamba2 as M
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import build_optimizer
from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path, tree_unflatten)

MAMBA_REL = 5e-5          # gradients through Mamba2 blocks

# the reference's trainer and server on the cases in turn, each case's
# overrides through get_arch(...).reduced() and its cross gates through
# Model.init; "=== <run>" before each run's log lines
REF = """
import json, sys
import jax.numpy as jnp
import repro.configs as RC
from repro.launch import serve, train
from repro.models import model as RM
get_arch, init, case = RC.get_arch, RM.Model.init, {}

def case_arch(name):
    cfg = get_arch(name)
    small = cfg.reduced(**case["over"])
    object.__setattr__(cfg, "reduced", lambda: small)
    return cfg

def gated_init(self, rng):
    p = init(self, rng)
    for pos in p["blocks"].values():
        if case["gates"] is not None and "gate" in pos["mixer"]:
            pos["mixer"]["gate"] = jnp.full_like(pos["mixer"]["gate"],
                                                 case["gates"])
    return p

RC.get_arch, RM.Model.init = case_arch, gated_init
tokens = {}
for over, gates, runs in json.loads(sys.argv[1]):
    case.update(over=over, gates=gates)
    for kind, name, flags in runs:
        print("===", name, flush=True)
        if kind == "train":
            train.main(flags)
        else:
            tokens[name] = serve.main(flags).tolist()
json.dump(tokens, open("serve.json", "w"))
"""


# run here on threads standing in for the ranks (no process launch),
# against the same reference subprocess: deepseek-v3-671b's latent
# attention with 6 heads over model 4 (1.5 heads a shard: wq_b's 288
# columns, wkv_b's 384 and wo's 192 rows in blocks that cut a head), MTP
# and 4 experts (one a shard); its auto step and its serving at batch 4
THREAD_CASES = {
    "deepseek6": ("deepseek-v3-671b", {"n_heads": 6}, (1, 4), None),
}


def _ref_runs(tmp):
    """The reference's runs of every case: [overrides, gates, [(kind, run
    name, flags)]]; its lgc_rar checkpoints under tmp/<case>.lgc."""
    out = []
    for name, (arch, over, (data, model), gates) in {
            **W.CASES, **THREAD_CASES}.items():
        flags = ["--data-shards", str(data), "--model-shards", str(model),
                 "--arch", arch]
        runs = [("train", f"{name} auto", W.AUTO + flags + [
            "--metrics-out", str(tmp / f"{name}.auto.json")])]
        if name in W.LGC_CASES:
            runs.append(("train", f"{name} lgc", W.LGC + flags + [
                "--metrics-out", str(tmp / f"{name}.lgc.json"),
                "--checkpoint-dir", str(tmp / f"{name}.lgc")]))
        for run, B in (W.serve_runs(name) if name in W.CASES
                       else [(f"{name} b4", 4)]):
            mesh = flags if B > 1 else ["--data-shards", "2", "--arch", arch]
            runs.append(("serve", run, W.SERVE + mesh + ["--batch", str(B)]))
        out.append([over, gates, runs])
    return out


def _reference_init(name):
    """The reference trainer's initial weights and AE (PRNGKey(0)) of a
    case, its gates set: {p<i>, a<i>} numpy in tree order (a thread
    case's weights alone)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as ref_get_arch
    from repro.configs.base import CompressionConfig as RCC
    from repro.core import build_compressor
    from repro.models.model import Model as RefModel
    arch, over, _, gates = {**W.CASES, **THREAD_CASES}[name]
    key = jax.random.PRNGKey(0)
    rparams = jax.jit(RefModel(ref_get_arch(arch).reduced(**over)).init)(key)
    for pos in rparams["blocks"].values():
        if gates is not None and "gate" in pos["mixer"]:
            pos["mixer"]["gate"] = jnp.full_like(pos["mixer"]["gate"], gates)
    if name in THREAD_CASES:
        return {f"p{i}": np.asarray(a)
                for i, a in enumerate(jax.tree_util.tree_leaves(rparams))}
    rcc = RCC(method="lgc_rar", warmup_steps=1, ae_train_steps=1)
    ae = jax.jit(lambda k: build_compressor(rcc, rparams, 1)
                 .init_state(k)["ae"])(key)
    out = {f"p{i}": np.asarray(a)
           for i, a in enumerate(jax.tree_util.tree_leaves(rparams))}
    out.update({f"a{i}": np.asarray(a)
                for i, a in enumerate(jax.tree_util.tree_leaves(ae))})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_heads")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)        # the CLIs ask for their devices
    log = open(tmp / "ref.log", "w")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REF, json.dumps(_ref_runs(tmp))],
        cwd=str(tmp), env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        for name in {**W.CASES, **THREAD_CASES}:
            np.savez(tmp / f"{name}.npz", **_reference_init(name))
        launch(tmp, worker("_torch_tp_heads_worker.py") + [
            str(tmp), str(tmp / "out"), "{store}"], 4, timeout=600)
    finally:
        try:
            ref_proc.wait(timeout=600)
        finally:
            if ref_proc.poll() is None:
                ref_proc.kill()
            log.close()
    text = (tmp / "ref.log").read_text()
    assert ref_proc.returncode == 0, text[-3000:]
    ranks = []
    for r in range(4):
        with open(tmp / "out" / f"rank{r}.json") as f:
            rec = json.load(f)
        rec["arrays"] = dict(np.load(tmp / "out" / f"rank{r}.npz"))
        ranks.append(rec)
    logs = dict(re.findall(r"^=== (.+)\n((?:(?!=== ).*\n)*)", text, re.M))
    ref = {"serve": json.loads((tmp / "serve.json").read_text())}
    for name in {**W.CASES, **THREAD_CASES}:
        ref[name] = {"auto": [h["loss"] for h in json.loads(
            (tmp / f"{name}.auto.json").read_text())]}
        if name not in W.LGC_CASES:
            continue
        with np.load(tmp / f"{name}.lgc" / "ckpt.npz") as z:
            ref[name]["ckpt"] = {k: z[k] for k in z.files}
        ref[name]["lgc"] = [h["loss"] for h in json.loads(
            (tmp / f"{name}.lgc.json").read_text())]
        ref[name]["wire"] = {
            ph: ast.literal_eval(row) for ph, row in re.findall(
                r"phase=(\w+) wire bytes/node/step: (\{.*\})",
                logs[f"{name} lgc"])}
    return tmp, ranks, ref


def _mesh(name):
    return host_mesh(*W.CASES[name][2])


def _coords(name):
    data, model = W.CASES[name][2]
    return [{"data": r // model, "model": r % model} for r in range(4)]


def _tc(method):
    return TrainConfig(optimizer="sgd_momentum",
                       compression=CompressionConfig(method=method))


def _predicted(name, method):
    """``launch.dryrun``'s bytes a device holds for the step on the
    case's mesh, the momentum SGD state priced by the same rules."""
    cfg, mesh = W.cfg_of(name), _mesh(name)
    model = build_model(cfg)
    out, _ = dryrun.per_device_bytes(
        model, InputShape("t", W.SEQ, W.BATCH, "train"), mesh,
        compression=method, fsdp="on")
    o_shapes = build_optimizer(_tc(method)).init(params_specs(model))
    data, mp = W.CASES[name][2]
    fsdp = ("data",) if method == "none" and data > 1 else ()
    out["optimizer"] = dryrun.local_bytes(o_shapes, SH.param_pspecs(
        o_shapes, model_size=mp, fsdp_axes=fsdp,
        fsdp_size=data if fsdp else 1), mesh.axis_sizes)
    return out


def _rel(name, key):
    return MAMBA_REL if name.startswith("mamba") and "/mixer/" in key \
        else 1e-5


def _full(tmp, name):
    return W.case_init(str(tmp), name)[0]


def test_each_mesh_cuts_a_head():
    """Each case's model axis cuts a head (the reason of the case), and
    its model builds under that many shards."""
    class Stub:
        def __init__(self, mp):
            self.size, self.index = mp, 0
    for name in W.CASES:
        cfg, mp = W.cfg_of(name), W.CASES[name][2][1]
        heads = [cfg.n_heads, cfg.n_kv_heads] if cfg.n_heads else []
        if cfg.ssm is not None:
            heads.append(M._dims(cfg)[2])
        assert any(h % mp for h in heads), (name, heads, mp)
        Model(cfg, Shards(model=Stub(mp)))


@pytest.mark.parametrize("name", W.CASES)
def test_auto_step_matches_reference(runs, name):
    tmp, ranks, ref = runs
    cfg, full = W.cfg_of(name), _full(tmp, name)
    batch = W.batch_of(cfg)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(full)]
    loss, _ = build_model(cfg).loss(tree_unflatten(full, leaves), batch)
    grads = tree_unflatten(full, list(torch.autograd.grad(loss, leaves)))
    pspecs = steps.auto_train_pspecs(build_model(cfg), _tc("none"),
                                     _mesh(name))[0]
    predicted = _predicted(name, "none")
    for r, rec in enumerate(ranks):
        got = rec[f"{name} auto"]
        np.testing.assert_allclose([h["loss"] for h in got["history"]],
                                   ref[name]["auto"], rtol=0, atol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["first"]["loss"], loss.item(),
                                   rtol=0, atol=1e-5)
        block = SH.shard_tree(grads, pspecs, _coords(name)[r],
                              _mesh(name).axis_sizes)
        for i, ((path, g), whole) in enumerate(zip(
                tree_leaves_with_path(block), tree_leaves(grads))):
            key = keystr_path(path)
            np.testing.assert_allclose(
                rec["arrays"][f"{name}/auto_g{i}"], g.numpy(), rtol=0,
                atol=_rel(name, key) * float(whole.abs().max()),
                err_msg=f"rank {r} gradient {key}")
        held = got["held"]
        assert (held["params"], held["optimizer"], held["compressor"]) == (
            predicted["params"], predicted["optimizer"], 0), (r, held)


@pytest.mark.parametrize("name", W.LGC_CASES)
def test_lgc_step_matches_reference(runs, name):
    tmp, ranks, ref = runs
    want, predicted = ref[name], _predicted(name, "lgc_rar")
    rel = MAMBA_REL if name.startswith("mamba") else 2e-5
    for r, rec in enumerate(ranks):
        d, m = _coords(name)[r]["data"], _coords(name)[r]["model"]
        got = rec[f"{name} lgc"]
        np.testing.assert_allclose([h["loss"] for h in got["history"]],
                                   want["lgc"], rtol=0, atol=1e-5,
                                   err_msg=f"rank {r}")
        assert [h["phase"] for h in got["history"]] == [
            "warmup", "topk_ae", "compressed"]
        # each phase's bytes a node per op kind; one node (data 1) moves
        # none, and the reference logs no row
        rows = {}
        for phase, row in got["wire"].items():
            kinds = {}
            for op in row.values():
                for kind, b in op.items():
                    kinds[kind] = kinds.get(kind, 0) + b
            if kinds:
                rows[phase] = kinds
        assert rows == want["wire"], (r, rows, want["wire"])
        assert bool(rows) == (W.CASES[name][2][0] > 1), (r, rows)
        ours = {k: rec["arrays"][f"{name}/{k}"] for k in ("u", "v")}
        theirs = {k: want["ckpt"][f"comp_state/{k}"][d, m]
                  for k in ("u", "v")}
        np.testing.assert_array_equal(
            (ours["u"] == 0) & (ours["v"] == 0),
            (theirs["u"] == 0) & (theirs["v"] == 0), f"rank {r} cleared")
        for key in ("u", "v"):
            close(ours[key], theirs[key], rel, f"rank {r} {key}")
        assert got["held"] == {k: predicted[k] for k in got["held"]}, (
            r, got["held"])
    for i, (path, _) in enumerate(tree_leaves_with_path(_full(tmp, name))):
        key = keystr_path(path)
        close(ranks[0]["arrays"][f"{name}/lgc_p{i}"],
              want["ckpt"]["params/" + key], rel, f"{name} {key}")


def test_serving_matches_reference(runs):
    tmp, ranks, ref = runs
    for name in W.CASES:
        cfg, data = W.cfg_of(name), W.CASES[name][2][0]
        n_rings = sum(k == "attn" for k in cfg.block_pattern)
        for run, B in W.serve_runs(name):
            one = serve.run(cfg, serve.parse_args(
                W.SERVE + ["--batch", str(B), "--device", "cpu"]),
                params=_full(tmp, name))
            assert one["tokens"].tolist() == ref["serve"][run], run
            want, _ = dryrun.per_device_bytes(
                build_model(cfg),
                InputShape("d", W.PROMPT + W.GEN, B, "decode"), _mesh(name))
            S = W.PROMPT + W.GEN
            extra = 4 * n_rings * cfg.n_blocks * S // 2 \
                if B > 1 and data > 1 else 0
            for r, rec in enumerate(ranks):
                assert rec[run]["tokens"] == ref["serve"][run], (r, run)
                close(rec["arrays"][f"{run}/logits"], one["logits"], 1e-5,
                      f"rank {r} {run} logits")
                assert rec[run]["held"] == {
                    "params": want["params"],
                    "cache": want["cache"] + extra}, (r, run)


def test_cut_latent_heads_match_reference(runs):
    """deepseek's 6 latent-attention heads over model 4 (THREAD_CASES),
    each rank a thread: the auto step's 3 losses (momentum SGD, the
    trainer's schedule and batches) within 1e-5 of the reference's, and
    the greedy tokens at batch 4 (prefill, then the absorbed decode
    against the latent cache split over model) the reference's."""
    tmp, _, ref = runs
    name = "deepseek6"
    arch, over, (data, model), _ = THREAD_CASES[name]
    cfg = get_arch(arch).reduced(**over)
    assert cfg.n_heads % model and cfg.mla is not None and cfg.mtp_depth
    full = TW.whole_params(cfg, TW.init_arrays(str(tmp / f"{name}.npz"))[0])
    tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1,
                     steps=W.AUTO_STEPS,
                     compression=CompressionConfig(method="none"))
    args = serve.parse_args(W.SERVE + ["--batch", "4", "--device", "cpu"])

    def rank(grid):
        ats = steps.make_auto_train_step(build_model(cfg), tc, grid)
        params, opt_state = ats.init_from(full)
        stream = synthetic_token_batches(cfg.vocab_size, W.BATCH, W.SEQ,
                                         seed=0)
        losses = []
        for step in range(W.AUTO_STEPS):
            params, opt_state, metrics = ats.step(
                params, opt_state, train.to_device(next(stream), "cpu"),
                step)
            losses.append(float(metrics["loss"]))
        res = serve._serve(cfg, args, full, grid.device, grid)
        return losses, res["tokens"].tolist()
    for r, (losses, tokens) in enumerate(run_ranks(
            rank, thread_grids(1, data, model))):
        np.testing.assert_allclose(losses, ref[name]["auto"], rtol=0,
                                   atol=1e-5, err_msg=f"rank {r}")
        assert tokens == ref["serve"][f"{name} b4"], r
