"""One rank of tests/test_torch_tp_kinds.py's launch: a world of 4
processes at ``reduced()`` configs, from the reference's initial weights
and AE of each arch (INIT/<arch>.npz: p<i>, a<i>), one process set
through every part in turn, each joining its own process group (STORE
with a suffix) and leaving it:

- ``repair``: the auto step's first step at (data 4, model 1) on
  deepseek-v3-671b: its metrics (loss, xent, mtp_loss, aux_loss);
- ``auto``: the auto step (TP over model, FSDP over data) on (2, 2) for
  each arch (vision with its gates at 0.5): the first step's metrics and
  gradient blocks, then the trainer's ``--compression none`` run;
- ``lgc``: lgc_rar on (2, 2) for each arch, 3 steps (one a phase), but
  jamba's first step alone;
- ``resume``: jamba's lgc_rar steps 1 and 2, each alone from the
  reference's state before it: the trainer's own ``--resume`` of the
  reference's gathered checkpoints INIT/<arch>.s<i>/ckpt.npz after i
  steps (waited for as INIT/<arch>.s<i>.done), each rank cutting its
  blocks from the file (``checkpoint.load_gathered_checkpoint``): over
  three steps one f32 near-tie that crosses a selection threshold would
  change every later gradient (jamba's Mamba2 gradients lie up to 3.1e-5
  of their largest entry from f64's), so each step is held from the same
  state;
- ``serve``: greedy serving of each arch at batch 4 (the batch over
  data, the heads over model) and batch 1 (the cache split over data),
  vision also at batch 4 with its gates at 0.5, mamba2-130m at batch 4.

The records go to OUT/rank<r>.json and OUT/rank<r>.npz.

    RANK=r WORLD_SIZE=4 python tests/_torch_tp_kinds_worker.py INIT OUT \\
        STORE [PART ...]
"""
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import _torch_tp_worker as TW
from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import serve, steps, train
from repro_torch.launch.mesh import init_process_mesh
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

ARCHS = ("jamba-v0.1-52b", "deepseek-v3-671b", "llama-3.2-vision-90b")
REPAIR = "deepseek-v3-671b"
RESUME = "jamba-v0.1-52b"        # each step from the reference's state
GATE = 0.5
BATCH, SEQ = 8, 32
COMMON = ["--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
          "--log-every", "1", "--optimizer", "sgd_momentum", "--lr", "0.1"]
TRAIN = COMMON + ["--data-shards", "2", "--model-shards", "2"]
AUTO_STEPS = 2
AUTO = TRAIN + ["--compression", "none", "--steps", str(AUTO_STEPS)]
# one step a phase: warm-up, top-k + the AE's training, compressed
LGC = TRAIN + ["--compression", "lgc_rar", "--warmup-steps", "1",
               "--ae-train-steps", "1", "--steps", "3"]
# the reference's default selection (jnp); its CLI runs beside
PORT_LGC = ["--topk-backend", "jnp", "--ae-backend", "pallas"]
PROMPT, GEN = 16, 4
SERVE = ["--smoke", "--prompt-len", str(PROMPT), "--gen", str(GEN)]
SERVE_B4 = SERVE + ["--data-shards", "2", "--model-shards", "2", "--batch",
                    "4"]
SERVE_B1 = SERVE + ["--data-shards", "2", "--batch", "1"]
PORT = ["--device", "cpu", "--dist-backend", "gloo"]
# the serving runs: (name, arch, flags, gates); the reference's B1 runs
# on (data 2), the port's on (data 2, model 2)
SERVES = [(f"{a} {b}", a, flags, None) for a in ARCHS
          for b, flags in (("b4", SERVE_B4),
                           ("b1", SERVE_B1 + ["--model-shards", "2"]))] + [
    ("llama-3.2-vision-90b b4 gates", "llama-3.2-vision-90b", SERVE_B4,
     GATE),
    ("mamba2-130m b4", "mamba2-130m", SERVE_B4, None)]


LGC_INIT = steps.LGCTrainStep.init


def start_from(full, ae_leaves):
    """Every step builder's init starts from the weights ``full`` and the
    AE's leaves (when its method has an AE), the AE momentum zero and the
    optimizer state fresh (``_torch_tp_worker.start_from``, each time
    from the unpatched init)."""
    def lgc(self, gen):
        _, _, comp = LGC_INIT(self, gen)
        params = full if self.specs is None else \
            steps.shard_params(full, self.specs, self.grid)
        if "ae" in comp:
            comp["ae"] = tree_unflatten(comp["ae"], [
                torch.from_numpy(a) for a in ae_leaves])
            comp["ae_mom"] = tree_map(torch.zeros_like, comp["ae"])
        return params, self.optimizer.init(params), comp
    steps.LGCTrainStep.init = lgc
    steps.AutoTrainStep.init = lambda self, gen: self.init_from(full)


def wait_for(path, timeout=400.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.5)


def set_gates(params, value):
    """Every cross-attention gate of ``params`` (whole) set to ``value``."""
    for pos in params["blocks"].values():
        if "gate" in pos["mixer"]:
            pos["mixer"]["gate"].fill_(value)
    return params


def arch_init(init, arch, gates=None):
    """(whole params, AE leaves) of INIT/<arch>.npz."""
    cfg = get_arch(arch).reduced()
    p_leaves, ae_leaves = TW.init_arrays(os.path.join(init, f"{arch}.npz"))
    full = TW.whole_params(cfg, p_leaves)
    return (full if gates is None else set_gates(full, gates)), ae_leaves


def batch_of(cfg):
    return train.to_device(next(synthetic_token_batches(
        cfg.vocab_size, BATCH, SEQ, seed=0,
        encoder_tokens=cfg.num_encoder_tokens,
        encoder_dim=cfg.encoder_dim)), "cpu")


def first_step(arch, full, store, data, model):
    """The auto step's first-step metrics and gradient blocks on (data,
    model)."""
    cfg = get_arch(arch).reduced()
    grid = init_process_mesh((data,), "gloo", "cpu", store, model=model)
    try:
        tc = TrainConfig(optimizer="sgd_momentum",
                         compression=CompressionConfig(method="none"))
        ats = steps.make_auto_train_step(build_model(cfg), tc, grid)
        params, _ = ats.init_from(full)
        metrics, grads = ats.grads_and_metrics(params, batch_of(cfg))
        return ({k: float(v) for k, v in metrics.items()},
                [g.numpy() for g in tree_leaves(grads)])
    finally:
        dist.destroy_process_group()


def main(init, out, store, *parts):
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    parts = parts or ("repair", "auto", "lgc", "serve", "resume")
    rec, arrays = {}, {}
    if "repair" in parts:
        full, _ = arch_init(init, REPAIR)
        rec["repair"], _ = first_step(REPAIR, full, store + ".repair", 4, 1)
    for arch in ARCHS if "auto" in parts else ():
        full, ae = arch_init(init, arch, GATE)
        m, grads = first_step(arch, full, f"{store}.{arch}.g", 2, 2)
        arrays.update({f"{arch}/auto_g{i}": g for i, g in enumerate(grads)})
        start_from(full, ae)
        res = train.run(get_arch(arch).reduced(), train.parse_args(
            AUTO + PORT + ["--arch", arch, "--dist-init",
                           f"{store}.{arch}.auto"]))
        rec[f"{arch} auto"] = {"first": m, "history": res["history"],
                               "held": res["held"]}
    for arch in ARCHS if "lgc" in parts else ():
        full, ae = arch_init(init, arch)
        start_from(full, ae)
        res = train.run(get_arch(arch).reduced(), train.parse_args(
            LGC + PORT_LGC + PORT + [
                "--arch", arch, "--dist-init", f"{store}.{arch}.lgc",
                "--report", os.path.join(out, arch)]
            + (["--steps", "1"] if arch == RESUME else [])))
        rec[f"{arch} lgc"] = {"history": res["history"], "wire": res["wire"],
                              "held": res["held"]}
        arrays[f"{arch}/u"] = res["comp_state"]["u"].numpy()
        arrays[f"{arch}/v"] = res["comp_state"]["v"].numpy()
        if rank == 0:
            arrays.update({f"{arch}/lgc_p{i}": x.numpy() for i, x in
                           enumerate(tree_leaves(res["full_params"]))})
    for name, arch, flags, gates in SERVES if "serve" in parts else ():
        full, _ = arch_init(init, arch, gates)
        res = serve.run(get_arch(arch).reduced(), serve.parse_args(
            flags + PORT + ["--arch", arch, "--dist-init",
                            f"{store}.{name.replace(' ', '.')}"]),
            params=full)
        rec[name] = {"tokens": res["tokens"].tolist(), "held": res["held"]}
        arrays[f"{name}/logits"] = res["logits"]
    steps.LGCTrainStep.init = LGC_INIT
    for saved in (1, 2) if "resume" in parts else ():
        stem = os.path.join(init, f"{RESUME}.s{saved}")
        wait_for(stem + ".done")
        res = train.run(get_arch(RESUME).reduced(), train.parse_args(
            LGC + PORT_LGC + PORT + [
                "--steps", str(saved + 1), "--arch", RESUME, "--resume",
                os.path.join(stem, "ckpt.npz"), "--dist-init",
                f"{store}.{RESUME}.s{saved}", "--report",
                os.path.join(out, f"{RESUME}.s{saved}")]))
        start = res["resumed"]["step"]
        assert (start, res["resumed"]["layout"]) == (saved, "gathered"), \
            res["resumed"]
        key = f"{RESUME} step {start}"
        phase = res["history"][0]["phase"]
        rec[key] = {"history": res["history"], "held": res["held"],
                    "wire": {phase: res["wire"][phase]}}
        arrays[f"{key}/u"] = res["comp_state"]["u"].numpy()
        arrays[f"{key}/v"] = res["comp_state"]["v"].numpy()
        if rank == 0:
            arrays.update({f"{key}/lgc_p{i}": x.numpy() for i, x in
                           enumerate(tree_leaves(res["full_params"]))})
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
    print("PASS")
