"""One rank of tests/test_torch_tp_heads.py's launch: a world of 4
processes, ``--model-shards`` on meshes whose model axis cuts a head, at
``reduced()`` configs (CASES), each from the reference's initial weights
and AE (INIT/<case>.npz: p<i>, a<i>), one process set through every run
in turn, each joining its own process group (STORE with a suffix) and
leaving it:

- the auto step's first step: its metrics and gradient blocks;
- the trainer's auto step (``--compression none``), 3 steps;
- lgc_rar through its three phases, one step a phase (LGC_CASES);
- greedy serving at batch 4 (the batch over data where there is one),
  and on the (data 2, model 2) mesh at batch 1 (the cache split along
  the sequence over data).

The records go to OUT/rank<r>.json and OUT/rank<r>.npz.

    RANK=r WORLD_SIZE=4 python tests/_torch_tp_heads_worker.py INIT OUT \\
        STORE
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_tp_kinds_worker as KW
import _torch_tp_worker as TW
from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import serve, steps, train
from repro_torch.launch.mesh import init_process_mesh
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_leaves

# name: (arch, reduced() overrides, (data, model), cross gates).  Each
# mesh's model axis cuts a head:
# - qwen2: 8 query and 2 kv heads (hd 32, qkv bias) over 4: half a kv
#   head a shard, the query heads whole;
# - q6kv3: 6 query and 3 kv heads over 4: 1.5 query and 0.75 kv heads a
#   shard (each shard attends 2 query-head slots, the last shard's a
#   repeat), and over model 2 with data 2: 1.5 kv heads a shard;
# - mamba6: d_inner 192 = 6 Mamba2 heads of 32 over 4 (out_proj's rows
#   1.5 heads a shard; in_proj's 422 columns replicated);
# - vision: 8 query and 2 kv heads over 4, in self- and cross-attention
#   (the cross cache f32), the cross gates at 0.5.
CASES = {
    "qwen2": ("qwen2-1.5b", {}, (1, 4), None),
    "q6kv3": ("llama3.2-1b", {"n_heads": 6, "n_kv_heads": 3}, (1, 4), None),
    "q6kv3 2x2": ("llama3.2-1b", {"n_heads": 6, "n_kv_heads": 3}, (2, 2),
                  None),
    "mamba6": ("mamba2-130m", {"d_model": 96}, (1, 4), None),
    "vision": ("llama-3.2-vision-90b", {"n_kv_heads": 2}, (1, 4), 0.5),
}
# the cases lgc_rar runs on: its compressor reads each shard's gradient
# blocks alike whatever cut them, so the auto step's gradients and the
# serving hold q6kv3's query-head slots and vision's cross-attention,
# and their lgc_rar runs (vision's the reference's slowest compile by
# far) are left out of the module's budget
LGC_CASES = ("qwen2", "q6kv3 2x2", "mamba6")
BATCH, SEQ = 8, 32
COMMON = ["--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
          "--log-every", "1", "--optimizer", "sgd_momentum", "--lr", "0.1"]
AUTO_STEPS = 3
AUTO = COMMON + ["--compression", "none", "--steps", str(AUTO_STEPS)]
LGC = COMMON + ["--compression", "lgc_rar", "--warmup-steps", "1",
                "--ae-train-steps", "1", "--steps", "3"]
PORT_LGC = ["--topk-backend", "fused", "--ae-backend", "pallas"]
PROMPT, GEN = 16, 4
SERVE = ["--smoke", "--prompt-len", str(PROMPT), "--gen", str(GEN)]
PORT = ["--device", "cpu", "--dist-backend", "gloo"]


def cfg_of(name):
    arch, over, _, _ = CASES[name]
    return get_arch(arch).reduced(**over)


def mesh_flags(name):
    data, model = CASES[name][2]
    return ["--data-shards", str(data), "--model-shards", str(model)]


def serve_runs(name):
    """(run name, batch) of a case's serving: batch 4, and batch 1 (the
    sequence split over data) where the mesh has a data axis."""
    data = CASES[name][2][0]
    return [(f"{name} b4", 4)] + ([(f"{name} b1", 1)] if data > 1 else [])


def case_init(init, name):
    """(whole params, AE leaves) of INIT/<name>.npz (its gates set)."""
    p_leaves, ae_leaves = TW.init_arrays(os.path.join(init, f"{name}.npz"))
    return TW.whole_params(cfg_of(name), p_leaves), ae_leaves


def batch_of(cfg):
    return train.to_device(next(synthetic_token_batches(
        cfg.vocab_size, BATCH, SEQ, seed=0,
        encoder_tokens=cfg.num_encoder_tokens,
        encoder_dim=cfg.encoder_dim)), "cpu")


def first_step(name, full, store):
    """The auto step's first-step metrics and gradient blocks."""
    cfg = cfg_of(name)
    data, model = CASES[name][2]
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


def main(init, out, store):
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    rec, arrays = {}, {}
    for name in CASES:
        cfg, arch = cfg_of(name), CASES[name][0]
        tag = name.replace(" ", ".")
        flags = mesh_flags(name) + PORT + ["--arch", arch]
        full, ae = case_init(init, name)
        m, grads = first_step(name, full, f"{store}.{tag}.g")
        arrays.update({f"{name}/auto_g{i}": g for i, g in enumerate(grads)})
        KW.start_from(full, ae)
        res = train.run(cfg, train.parse_args(
            AUTO + flags + ["--dist-init", f"{store}.{tag}.auto"]))
        rec[f"{name} auto"] = {"first": m, "history": res["history"],
                               "held": res["held"]}
        if name in LGC_CASES:
            res = train.run(cfg, train.parse_args(
                LGC + PORT_LGC + flags + [
                    "--dist-init", f"{store}.{tag}.lgc", "--report",
                    os.path.join(out, tag)]))
            rec[f"{name} lgc"] = {"history": res["history"],
                                  "wire": res["wire"], "held": res["held"]}
            arrays[f"{name}/u"] = res["comp_state"]["u"].numpy()
            arrays[f"{name}/v"] = res["comp_state"]["v"].numpy()
            if rank == 0:
                arrays.update({f"{name}/lgc_p{i}": x.numpy() for i, x in
                               enumerate(tree_leaves(res["full_params"]))})
        for run, B in serve_runs(name):
            res = serve.run(cfg, serve.parse_args(
                SERVE + flags + ["--batch", str(B), "--dist-init",
                                 f"{store}.{run.replace(' ', '.')}"]),
                params=full)
            rec[run] = {"tokens": res["tokens"].tolist(),
                        "held": res["held"]}
            arrays[f"{run}/logits"] = res["logits"]
    steps.LGCTrainStep.init = KW.LGC_INIT
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
    print("PASS")
