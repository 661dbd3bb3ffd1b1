"""``--model-shards`` for the other block kinds: MoE with expert
parallelism, Mamba2, latent attention with the MTP head, and
cross-attention, one process a shard, at ``reduced()`` jamba-v0.1-52b
(Mamba2, attention, MoE), deepseek-v3-671b (MLA, MTP, MoE with a shared
expert) and llama-3.2-vision-90b (cross-attention); and the auto step's
loss on the whole batch (its MTP term and the MoE layers' dispatch
groups and aux loss).

One launch (tests/_torch_tp_kinds_worker.py: world 4, gloo) runs every
part from the reference's initial weights and AE of each arch (its
``model.init`` and AE at PRNGKey(0), jitted, as its trainer draws them),
while the reference's trainer runs lgc_rar on (data 2, model 2) in two
subprocesses beside it (jamba alone, as three runs of one step, each
resumed from the last one's checkpoint; deepseek, then vision).  The auto
step and serving are held to the one-process port on the whole batch,
which tests/test_torch_archs_moe_ssm.py and
tests/test_torch_archs_mla_cross.py hold to the reference (loss, aux,
MTP loss, every gradient, prefill and decode at ``reduced()``):

- the repair: the auto step at (data 4, model 1) on deepseek: its loss,
  xent, mtp_loss and aux_loss within 1e-5 of the whole batch's (before
  the repair each rank's MTP term was its own rows' mean, about 4x too
  large summed, and its aux the product of its own means);
- the auto step on (2, 2) (vision's gates at 0.5): the first step's
  metrics, and each rank's gradient blocks within 1e-5 of the largest
  entry of each leaf (5e-5 through Mamba2 blocks: f32's floor there,
  tests/_torch_arch_checks.py) of the one-process gradient cut by the
  spec; the trainer's two steps' losses within 1e-5 of the one-process
  trainer's; held bytes the dry run's;
- lgc_rar on (2, 2) through its three phases: losses within 1e-5, each
  phase's wire bytes per op kind the reference's logged rows, held
  bytes the dry run's, each rank's cleared entries of u and v those of
  the reference's ``comp_state`` [d, m], its u, v and the gathered
  params within 2e-5 of the largest of the reference's saved ones.
  Jamba's gradients lie up to 3.1e-5 of their largest entry from f64's
  in one f32 evaluation (tests/_torch_arch_checks.py): over three steps
  in one run that moved a few values across the top-k threshold (2 to 8
  entries a rank), and a different selection changes every later
  gradient.  So jamba's steps run each alone from the reference's state
  before it (the trainer's ``--resume`` of its gathered checkpoints
  after 1 and 2 steps, each rank cutting its blocks; the first step from
  the initial state), each held as above at 5e-5 with no entry exempt
  (measured: u, v within 2.4e-5, params 2.1e-5, the cleared entries
  equal);
- serving: greedy tokens of every rank equal to one process's and the
  last logits within 1e-5 at batch 4 (the batch over data, the heads and
  experts over model) and batch 1 (the caches split over data: the
  slots, the latent's, the encoder tokens, a Mamba2 state's heads),
  vision at batch 4 also with its gates at 0.5, mamba2-130m at batch 4
  (a cache with no attention leaf); each rank's held bytes the dry
  run's, but at batch 4 the position rings: the reference's rule splits
  an (n_blocks, S) ring's S over data (it reads dim 1 as the batch),
  every process here holds the whole ring.

Without a launch: the MoE dispatch of one rank's rows with the whole
batch's groups at a capacity that drops, threads standing in for the
ranks, against one process; meshes that split a latent-attention head
(deepseek's 8 over 16 and over 3) and a cross-attention kv head, held to
one process (threads standing in for the shards).
"""
import ast
import json
import os
import re
import subprocess
import sys
import threading
from dataclasses import replace

import numpy as np
import pytest
import torch

import _torch_tp_kinds_worker as W
from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_pg import REPO, launch, worker
from _torch_tp_threads import shards_and_one_process
from _torch_train_common import close
from repro_torch.configs import get_arch
from repro_torch.configs.base import (CompressionConfig, InputShape,
                                      TrainConfig)
from repro_torch.dist import sharding as SH
from repro_torch.dist.tp import Shards
from repro_torch.launch import dryrun, serve, steps, train
from repro_torch.launch.input_specs import params_specs
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import build_optimizer
from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path, tree_unflatten)

MESH = host_mesh(2, 2)
COORDS = [{"data": r // 2, "model": r % 2} for r in range(4)]
INITS = W.ARCHS + ("mamba2-130m",)
# each arch's run of 3 steps, jamba's as 3 runs of one step, each
# resumed from the last one's checkpoint (<arch>.s<i>: after i steps)
REF_TRAIN = """
import json, sys
from repro.launch import train
for arch, flags, stops in json.loads(sys.argv[1]):
    start = 0
    for stop in stops:
        out = f"{arch}.s{stop}"
        more = [f"--resume={arch}.s{start}/ckpt.npz"] if start else []
        train.main(flags + more + ["--arch", arch, "--steps", str(stop),
                                   "--metrics-out", out + ".json",
                                   "--checkpoint-dir", out])
        open(out + ".done", "w").close()
        start = stop
"""
MAMBA_REL = 5e-5          # gradients through Mamba2 blocks (see above)


def _reference_init(arch):
    """The reference trainer's initial weights and AE (PRNGKey(0)): {p<i>,
    a<i>} numpy in tree order."""
    import jax
    from repro.configs import get_arch as ref_get_arch
    from repro.configs.base import CompressionConfig as RCC
    from repro.core import build_compressor
    from repro.models.model import Model as RefModel
    key = jax.random.PRNGKey(0)
    rparams = jax.jit(RefModel(ref_get_arch(arch).reduced()).init)(key)
    rcc = RCC(method="lgc_rar", warmup_steps=1, ae_train_steps=1)
    ae = jax.jit(lambda k: build_compressor(rcc, rparams, 2)
                 .init_state(k)["ae"])(key)
    out = {f"p{i}": np.asarray(a)
           for i, a in enumerate(jax.tree_util.tree_leaves(rparams))}
    out.update({f"a{i}": np.asarray(a)
                for i, a in enumerate(jax.tree_util.tree_leaves(ae))})
    return out


def _reference(tmp, name, archs):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)        # the CLI asks for its devices
    log = open(tmp / f"{name}.log", "w")
    arg = json.dumps([[a, W.LGC, [1, 2, 3] if a == W.RESUME else [3]]
                      for a in archs])
    return subprocess.Popen([sys.executable, "-c", REF_TRAIN, arg],
                            cwd=str(tmp), env=env, stdout=log,
                            stderr=subprocess.STDOUT), log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_kinds")
    # the reference's trainer draws its own initial state (PRNGKey(0));
    # the launch starts from the same, drawn here meanwhile
    refs = {"ref_a": W.ARCHS[:1], "ref_b": W.ARCHS[1:]}
    procs = [_reference(tmp, name, archs) for name, archs in refs.items()]
    try:
        for arch in INITS:
            np.savez(tmp / f"{arch}.npz", **_reference_init(arch))
        launch(tmp, worker("_torch_tp_kinds_worker.py") + [
            str(tmp), str(tmp / "out"), "{store}"], 4, timeout=400)
    finally:
        for p, log in procs:
            try:
                p.wait(timeout=400)
            finally:
                if p.poll() is None:
                    p.kill()
                log.close()
    logs = {name: (tmp / f"{name}.log").read_text() for name in refs}
    for (p, _), text in zip(procs, logs.values()):
        assert p.returncode == 0, text[-3000:]
    ranks = []
    for r in range(4):
        with open(tmp / "out" / f"rank{r}.json") as f:
            rec = json.load(f)
        rec["arrays"] = dict(np.load(tmp / "out" / f"rank{r}.npz"))
        ranks.append(rec)
    ref = {}
    for name, archs in refs.items():
        rows = re.findall(r"phase=(\w+) wire bytes/node/step: (\{.*\})",
                          logs[name])
        for i, arch in enumerate(archs):
            stops = (1, 2, 3) if arch == W.RESUME else (3,)
            ckpts = {}
            for stop in stops:
                with np.load(tmp / f"{arch}.s{stop}" / "ckpt.npz") as z:
                    ckpts[stop] = {k: z[k] for k in z.files}
            ref[arch] = {
                "losses": [h["loss"] for stop in stops for h in json.loads(
                    (tmp / f"{arch}.s{stop}.json").read_text())],
                "wire": {ph: ast.literal_eval(row)
                         for ph, row in rows[3 * i:3 * i + 3]},
                "ckpt": ckpts[3], "ckpts": ckpts}
    return tmp, ranks, ref


def _full(tmp, arch, gates=None):
    return W.arch_init(str(tmp), arch, gates)[0]


def _tc(method):
    return TrainConfig(optimizer="sgd_momentum",
                       compression=CompressionConfig(method=method))


def _predicted(cfg, method):
    """``launch.dryrun``'s bytes a device holds for the step on MESH, the
    momentum SGD state priced by the same rules (one f32 tree)."""
    model = build_model(cfg)
    out, _ = dryrun.per_device_bytes(
        model, InputShape("t", W.SEQ, W.BATCH, "train"), MESH,
        compression=method, fsdp="on")
    o_shapes = build_optimizer(_tc(method)).init(params_specs(model))
    fsdp = ("data",) if method == "none" else ()
    out["optimizer"] = dryrun.local_bytes(o_shapes, SH.param_pspecs(
        o_shapes, model_size=2, fsdp_axes=fsdp, fsdp_size=2 if fsdp else 1),
        MESH.axis_sizes)
    return out


def _whole_grads(cfg, full, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(full)]
    loss, metrics = build_model(cfg).loss(tree_unflatten(full, leaves),
                                          batch)
    return ({k: float(v) for k, v in metrics.items()},
            tree_unflatten(full, list(torch.autograd.grad(loss, leaves))))


def test_auto_step_loss_is_the_whole_batchs(runs):
    """At (data 4, model 1) each rank's rows give its share of the whole
    batch's loss: the sum over ranks is the one-process loss, MTP and
    aux included."""
    tmp, ranks, _ = runs
    cfg = get_arch(W.REPAIR).reduced()
    want, _ = _whole_grads(cfg, _full(tmp, W.REPAIR), W.batch_of(cfg))
    for r, rec in enumerate(ranks):
        for key in ("loss", "xent", "mtp_loss", "aux_loss", "tokens"):
            np.testing.assert_allclose(rec["repair"][key], want[key],
                                       rtol=1e-5, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("arch", W.ARCHS)
def test_auto_step_matches_one_process(runs, arch, monkeypatch):
    tmp, ranks, _ = runs
    cfg = get_arch(arch).reduced()
    full = _full(tmp, arch, W.GATE)
    batch = W.batch_of(cfg)
    want, grads = _whole_grads(cfg, full, batch)
    pspecs = steps.auto_train_pspecs(build_model(cfg), _tc("none"), MESH)[0]
    # the one-process trainer on the whole batch (one node, dense): the
    # auto step's twin
    args = train.parse_args(W.COMMON + ["--arch", arch, "--compression",
                                        "none", "--steps",
                                        str(W.AUTO_STEPS), "--device",
                                        "cpu"])
    init = steps.LGCTrainStep.init

    def start(self, gen):
        _, _, comp = init(self, gen)
        return full, self.optimizer.init(full), comp
    monkeypatch.setattr(steps.LGCTrainStep, "init", start)
    one = train.run(cfg, args)["history"]
    predicted = _predicted(cfg, "none")
    for r, rec in enumerate(ranks):
        got = rec[f"{arch} auto"]
        for key in want:
            np.testing.assert_allclose(got["first"][key], want[key],
                                       rtol=1e-5, err_msg=f"rank {r} {key}")
        block = SH.shard_tree(grads, pspecs, COORDS[r], MESH.axis_sizes)
        for i, ((path, g), whole) in enumerate(zip(
                tree_leaves_with_path(block), tree_leaves(grads))):
            key = keystr_path(path)
            rel = MAMBA_REL if "/mixer/" in key and arch.startswith(
                "jamba") else 1e-5
            # of the whole leaf's largest entry
            a, b = rec["arrays"][f"{arch}/auto_g{i}"], g.numpy()
            np.testing.assert_allclose(
                a, b, rtol=0, atol=rel * float(whole.abs().max()),
                err_msg=f"rank {r} gradient {key}")
        for key in ("loss", "mtp_loss"):
            np.testing.assert_allclose(
                [h.get(key, 0.0) for h in got["history"]],
                [h.get(key, 0.0) for h in one], rtol=0, atol=1e-5,
                err_msg=f"rank {r} {key}")
        held = got["held"]
        assert (held["params"], held["optimizer"], held["compressor"]) == (
            predicted["params"], predicted["optimizer"], 0), (r, held)


def _lgc_steps(arch, rec, want):
    """(the runs' records, their final u, v and params' keys, the
    reference's state after them, the tolerance): lgc_rar's three steps
    in one run, or jamba's each alone from the reference's state before
    it, through Mamba2's gradients (MAMBA_REL)."""
    if arch != W.RESUME:
        return [(rec[f"{arch} lgc"], arch, want["ckpts"][3], 2e-5)]
    return [(rec[f"{arch} lgc"], arch, want["ckpts"][1], MAMBA_REL)] + [
        (rec[f"{arch} step {s}"], f"{arch} step {s}", want["ckpts"][s + 1],
         MAMBA_REL) for s in (1, 2)]


@pytest.mark.parametrize("arch", W.ARCHS)
def test_lgc_step_matches_reference(runs, arch):
    tmp, ranks, ref = runs
    cfg = get_arch(arch).reduced()
    want, predicted = ref[arch], _predicted(cfg, "lgc_rar")
    for r, rec in enumerate(ranks):
        d, m = COORDS[r]["data"], COORDS[r]["model"]
        parts = _lgc_steps(arch, rec, want)
        history = [h for got, *_ in parts for h in got["history"]]
        np.testing.assert_allclose([h["loss"] for h in history],
                                   want["losses"], rtol=0, atol=1e-5,
                                   err_msg=f"rank {r}")
        assert [h["phase"] for h in history] == [
            "warmup", "topk_ae", "compressed"]
        wire = {ph: row for got, *_ in parts
                for ph, row in got["wire"].items()}
        assert set(wire) == set(want["wire"]), (r, sorted(wire))
        for phase, row in wire.items():
            kinds = {}
            for op in row.values():
                for kind, b in op.items():
                    kinds[kind] = kinds.get(kind, 0) + b
            assert kinds == want["wire"][phase], (r, phase, kinds)
        for got, name, ckpt, rel in parts:
            ours = {k: rec["arrays"][f"{name}/{k}"] for k in ("u", "v")}
            theirs = {k: ckpt[f"comp_state/{k}"][d, m] for k in ("u", "v")}
            # the entries each run cleared (u and v zeroed together)
            np.testing.assert_array_equal(
                (ours["u"] == 0) & (ours["v"] == 0),
                (theirs["u"] == 0) & (theirs["v"] == 0),
                f"rank {r} {name} cleared")
            for key in ("u", "v"):
                close(ours[key], theirs[key], rel, f"rank {r} {name} {key}")
            held = got["held"]
            assert held == {k: predicted[k] for k in held}, (r, held)
    for _, name, ckpt, rel in _lgc_steps(arch, ranks[0], want):
        for i, (path, _) in enumerate(tree_leaves_with_path(
                _full(tmp, arch))):
            key = keystr_path(path)
            close(ranks[0]["arrays"][f"{name}/lgc_p{i}"],
                  ckpt["params/" + key], rel, f"{name} {key}")


SERVE_CASES = {arch: [s for s in W.SERVES if s[1] == arch]
               for arch in INITS}


@pytest.mark.parametrize("arch", INITS)
def test_serving_matches_one_process(runs, arch):
    tmp, ranks, _ = runs
    cfg = get_arch(arch).reduced()
    n_rings = sum(k == "attn" for k in cfg.block_pattern)
    for name, _, flags, gates in SERVE_CASES[arch]:
        B = int(flags[flags.index("--batch") + 1])
        one = serve.run(cfg, serve.parse_args(
            W.SERVE + ["--arch", arch, "--batch", str(B), "--device",
                       "cpu"]), params=_full(tmp, arch, gates))
        want, _ = dryrun.per_device_bytes(
            build_model(cfg), InputShape("d", W.PROMPT + W.GEN, B, "decode"),
            MESH)
        # the whole int32 position rings at batch 4, half under the
        # reference's rule
        S = W.PROMPT + W.GEN
        extra = 4 * n_rings * cfg.n_blocks * S // 2 if B > 1 else 0
        for r, rec in enumerate(ranks):
            assert rec[name]["tokens"] == one["tokens"].tolist(), (r, name)
            close(rec["arrays"][f"{name}/logits"], one["logits"], 1e-5,
                  f"rank {r} {name} logits")
            held = rec[name]["held"]
            assert held == {"params": want["params"],
                            "cache": want["cache"] + extra}, (r, name, held)


class _Batch:
    """The batch group of n ranks seen from rank ``index``, its
    collectives through a barrier (threads standing in for ranks)."""

    def __init__(self, board, index):
        self.board, self.index = board, index
        self.size = len(board[1])

    def all_gather(self, x, dim):
        barrier, slots = self.board
        slots[self.index] = x
        barrier.wait()
        y = torch.cat(list(slots), dim)
        barrier.wait()
        return y

    def all_reduce(self, x):
        return self.all_gather(x[None], 0).sum(0)


def test_moe_dispatch_with_whole_batch_groups():
    """moe_fwd on 4 ranks' rows with ``tp.batch`` at capacity_factor 1.0
    (which drops tokens): each rank's output rows and the aux loss equal
    one process's on the whole batch, where whole groups lie in a rank
    (B 8 x S 32: 32 groups of 8) and where one group spans the ranks (S
    31: T = 248, one group)."""
    cfg = get_arch("deepseek-v3-671b").reduced()
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=1.0))
    g = torch.Generator().manual_seed(0)
    p = L.init_moe(g, cfg, torch.float32, "cpu")
    for S in (32, 31):
        x = torch.randn(8, S, cfg.d_model, generator=g)
        want, waux = L.moe_fwd(p, cfg, x)
        T = 8 * S
        C = L.moe_capacity(L.moe_group_size(T, 4), cfg.moe)
        assert C < L.moe_group_size(T, 4)          # the capacity drops
        board = (threading.Barrier(4), [None] * 4)
        out = [None] * 4

        def rank(i):
            tp = Shards(batch=_Batch(board, i))
            out[i] = L.moe_fwd(p, cfg, x[2 * i:2 * i + 2], tp=tp)
        ts = [threading.Thread(target=rank, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        for i, (y, aux) in enumerate(out):
            close(y.numpy(), want[2 * i:2 * i + 2].numpy(), 1e-6,
                  f"S {S} rank {i}")
            np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


class _Stub:
    def __init__(self, mp, m=0):
        self.size, self.index = mp, m


def test_a_mesh_that_splits_a_latent_or_cross_head_matches_one_process():
    """Once refused, now run: deepseek's 8 latent-attention heads over 16
    shards (half a head each; the shards past the eighth hold only
    repeats) and over 3 (2 2/3 heads each: ``wq_b``'s 384 columns in
    blocks that cut a head, ``wkv_b``'s 512 and ``wo``'s 256 rows
    replicated, and the MTP block's ``proj`` too), and vision's 4 kv
    heads over 8 shards (half a kv head each, in self- and
    cross-attention; gates at 0.5).  Threads standing in for the shards:
    each shard's loss (deepseek's MTP loss apart too), prefill and
    decode logits (deepseek's absorbed decode) within 1e-5 of one
    process's, its gradient blocks within 1e-5 of each leaf's largest
    entry.  mamba2-130m's 24 heads over 16 build
    (tests/test_torch_sharding.py runs its step and deepseek's at
    published widths)."""
    Model(get_arch("mamba2-130m"), Shards(model=_Stub(16)))
    for arch, mp in (("deepseek-v3-671b", 16), ("deepseek-v3-671b", 3),
                     ("llama-3.2-vision-90b", 8)):
        name = f"{arch} over {mp}"
        cfg = get_arch(arch).reduced()
        g = torch.Generator().manual_seed(0)
        full = build_model(cfg).init(g)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        if cfg.num_encoder_tokens:
            full = W.set_gates(full, W.GATE)
            batch["encoder_embeds"] = torch.randn(
                2, cfg.num_encoder_tokens, cfg.encoder_dim, generator=g)
        got, want = shards_and_one_process(cfg, mp, full, batch)
        for m, res in enumerate(got):
            for key in ["loss"] + (["mtp_loss"] if cfg.mtp_depth else []):
                np.testing.assert_allclose(
                    float(res["metrics"][key]), float(want["metrics"][key]),
                    rtol=0, atol=1e-5, err_msg=f"{name} shard {m} {key}")
            for key in ("logits", "step"):
                close(res[key].numpy(), want[key].numpy(), 1e-5,
                      f"{name} shard {m} {key}")
            for a, b in zip(res["grads"], want["grads"][m]):
                close(a.numpy(), b.numpy(), 1e-5,
                      f"{name} shard {m} gradient")
