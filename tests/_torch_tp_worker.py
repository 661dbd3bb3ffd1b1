"""One rank of tests/test_torch_tp.py's launch: a world of 4 processes,
the (data 2, model 2) mesh, at ``reduced()`` llama3.2-1b from the
reference's initial weights and AE, one process set through every path:

- the first step's gradients of the auto step and of the LGC step
  (each process's block), and ``gather_tree`` of ``shard_tree`` on the
  2 x 2 and 1 x 4 meshes;
- (i) the trainer's auto step (``--compression none``), 3 steps;
- (ii) lgc_rar through its three phases, 4 steps, saving its rank files
  at its end (OUT/lgc_final);
- each of (i) and (ii) again with ``--checkpoint-dir`` (OUT/<name>_ckpt),
  stopped after step 1 (lgc_rar's first sparsified step) by ``run()``'s
  ``on_step``, then resumed from its rank files at step 2;
- (iii) serving at batch 4: prefill and 3 decode steps, the batch over
  ``data``; once more with the weights also sharded over ``data``
  (``SERVE_FSDP_BYTES`` forced to 0);
- (iv) serving at batch 1, the cache split along the sequence.

Each part joins its own process group (STORE with a suffix) and leaves
it.  The records go to OUT/rank<r>.json and OUT/rank<r>.npz.

    RANK=r WORLD_SIZE=4 python tests/_torch_tp_worker.py INIT.npz OUT STORE
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.data import synthetic_token_batches
from repro_torch.dist.sharding import gather_tree
from repro_torch.launch import serve, steps, train
from repro_torch.launch.mesh import init_process_mesh
from repro_torch.models.model import build_model
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

BATCH, SEQ = 8, 32
# momentum SGD, linear in the gradient: AdamW's m/sqrt(v) turns a
# rounding-sized gradient difference at a near-zero gradient into a whole
# step (tests/_torch_train_common.py's trajectories use it for the same
# reason)
TRAIN = ["--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
         "--data-shards", "2", "--model-shards", "2", "--log-every", "1",
         "--optimizer", "sgd_momentum", "--lr", "0.1"]
AUTO = TRAIN + ["--compression", "none", "--steps", "3"]
LGC = TRAIN + ["--compression", "lgc_rar", "--warmup-steps", "1",
               "--ae-train-steps", "1", "--steps", "4"]
PORT_LGC = ["--topk-backend", "fused", "--ae-backend", "pallas"]
PROMPT, GEN = 16, 4
SERVE = ["--smoke", "--prompt-len", str(PROMPT), "--gen", str(GEN)]
SERVE_B4 = SERVE + ["--data-shards", "2", "--model-shards", "2", "--batch",
                    "4"]
SERVE_B1 = SERVE + ["--data-shards", "2", "--batch", "1"]
PORT = ["--device", "cpu", "--dist-backend", "gloo"]
# the reference's B1 run is on (data 2); the port's on (data 2, model 2):
# the sequence split over data with the heads over model
PORT_SERVE = {"b4": SERVE_B4, "b1": SERVE_B1 + ["--model-shards", "2"],
              "b4_fsdp": SERVE_B4}
MESHES = ((2, 2), (1, 4))


def init_arrays(path):
    """INIT.npz's weight leaves p<i> and AE leaves a<i>, in tree order."""
    with np.load(path) as d:
        return ([d[f"p{i}"] for i in range(len(d.files)) if f"p{i}" in d],
                [d[f"a{i}"] for i in range(len(d.files)) if f"a{i}" in d])


def whole_params(cfg, leaves):
    return tree_unflatten(build_model(cfg).init(torch.Generator(), "meta"),
                          [torch.from_numpy(np.array(x)) for x in leaves])


def start_from(full, ae_leaves):
    """Every step builder's init starts from the weights ``full`` and the
    AE's leaves, the AE momentum zero and the optimizer state fresh."""
    def lgc(self, gen):
        _, _, comp = lgc_init(self, gen)
        params = full if self.specs is None else \
            steps.shard_params(full, self.specs, self.grid)
        comp["ae"] = tree_unflatten(comp["ae"], [
            torch.from_numpy(a) for a in ae_leaves])
        comp["ae_mom"] = tree_map(torch.zeros_like, comp["ae"])
        return params, self.optimizer.init(params), comp
    lgc_init = steps.LGCTrainStep.init
    steps.LGCTrainStep.init = lgc
    steps.AutoTrainStep.init = lambda self, gen: self.init_from(full)


def first_grads(cfg, full, store, rank):
    """The auto step's and one LGC node's first-step gradient blocks."""
    grid = init_process_mesh((2,), "gloo", "cpu", store, model=2)
    try:
        batch = train.to_device(next(synthetic_token_batches(
            cfg.vocab_size, BATCH, SEQ, seed=0)), "cpu")
        tc = TrainConfig(optimizer="sgd_momentum",
                         compression=CompressionConfig(method="lgc_rar"))
        ats = steps.make_auto_train_step(build_model(cfg), tc, grid)
        params, _ = ats.init_from(full)
        loss, grads = ats.grads(params, batch)
        out = {f"auto_g{i}": g.numpy() for i, g in
               enumerate(tree_leaves(grads))}
        lts = steps.make_lgc_train_step(build_model(cfg), tc, 2, "cpu",
                                        (2,), grid.pm, grid)
        local = steps.shard_params(full, lts.specs, grid)
        g, _ = steps.grads_of_nodes(lts.model.loss, local, batch, 2,
                                    lts.compressor.layout.n_total,
                                    (grid.pm.node,))
        out["lgc_g"] = g[0].numpy()
        out["auto_loss"] = loss.numpy()
        # shard_tree, then gather_tree: the whole tree again, bit for bit
        same = {}
        for data, model in MESHES:
            if (data, model) != (2, 2):
                dist.destroy_process_group()
                grid = init_process_mesh((data,), "gloo", "cpu",
                                         f"{store}.{data}x{model}",
                                         model=model)
            specs = steps.auto_train_pspecs(build_model(cfg), tc,
                                            grid.spec)[0]
            local = params_from_numpy(tree_map(lambda t: t.numpy(), full),
                                      specs=specs, coords=grid.coords,
                                      sizes=grid.spec.axis_sizes)
            back = gather_tree(local, specs, grid.groups())
            same[f"{data}x{model}"] = all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(tree_leaves(back), tree_leaves(full)))
            same[f"{data}x{model}_sharded"] = sum(
                x.numel() for x in tree_leaves(local)) < sum(
                x.numel() for x in tree_leaves(full))
        return out, same
    finally:
        dist.destroy_process_group()


class Stop(Exception):
    pass


def digests(res):
    """This rank's own final train state's digest and its leaves'."""
    return {k: res["report"][k]
            for k in ("state_digest", "state_leaf_digests")}


def stop_and_resume(cfg, name, flags, out, store):
    """``flags``' run with a checkpoint after every step, stopped after
    step 1; then the run resumed from its rank files: their records."""
    ckpt = ["--checkpoint-dir", os.path.join(out, f"{name}_ckpt"),
            "--checkpoint-every", "1"]
    steps = []

    def on_step(h):
        steps.append(h)
        if h["step"] == 1:
            raise Stop
    try:
        train.run(cfg, train.parse_args(
            flags + PORT + ckpt + ["--dist-init", f"{store}.{name}.stop"]),
            on_step=on_step)
        raise AssertionError(f"{name}: the run was not stopped")
    except Stop:
        pass
    res = train.run(cfg, train.parse_args(flags + PORT + [
        "--resume", os.path.join(out, f"{name}_ckpt", "ckpt.npz"),
        "--dist-init", f"{store}.{name}.resume", "--report",
        os.path.join(out, f"{name}_resumed")]))
    return {f"{name} stopped": {"history": steps},
            f"{name} resumed": {"history": res["history"],
                                "resumed": res["resumed"], **digests(res)}}


def main(init, out, store):
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    cfg = get_arch("llama3.2-1b").reduced()
    p_leaves, ae_leaves = init_arrays(init)
    full = whole_params(cfg, p_leaves)
    start_from(full, ae_leaves)
    arrays, same = first_grads(cfg, full, store + ".grad", rank)
    rec = {"gather_inverse": same}
    for name, flags in (("auto", AUTO), ("lgc", LGC + PORT_LGC)):
        final = ["--checkpoint-dir", os.path.join(out, "lgc_final")] \
            if name == "lgc" else []
        res = train.run(cfg, train.parse_args(
            flags + PORT + final + ["--dist-init", f"{store}.{name}",
                                    "--report", os.path.join(out, name)]))
        rec[name] = {"history": res["history"], "wire": res["wire"],
                     "held": res["held"], **digests(res)}
        if rank == 0:
            arrays.update({f"{name}_p{i}": x.numpy() for i, x in
                           enumerate(tree_leaves(res["full_params"]))})
        if name == "lgc":
            arrays["u"] = res["comp_state"]["u"].numpy()
            arrays["v"] = res["comp_state"]["v"].numpy()
        rec.update(stop_and_resume(cfg, name, flags, out, store))
    for name, flags in PORT_SERVE.items():
        if name == "b4_fsdp":
            steps.SERVE_FSDP_BYTES = 0
        res = serve.run(cfg, serve.parse_args(flags + PORT + [
            "--dist-init", f"{store}.{name}"]), params=full)
        rec[name] = {"tokens": res["tokens"].tolist(), "held": res["held"]}
        arrays[f"{name}_logits"] = res["logits"]
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
    print("PASS")
