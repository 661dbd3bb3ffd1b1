"""One rank of a launch of tests/test_torch_pg_faults.py: several runs of
the port's trainer (``launch.train.run``) one after another in the same
processes, each joining its own process group, as PLAN.json lists them:

- ``{"argv": [...], "out": DIR}``: a run; with ``"stop_after": S`` it is
  stopped after step S by ``run()``'s ``on_step`` hook (which runs once
  that step's checkpoint is written, as a crash right after it would
  stop the run), and the records of the steps it ran go to
  DIR/rank<r>.json; with ``"expect": "<Error>"`` it must raise that
  exception, whose line ("<Error>: message") goes to DIR/rank<r>.json;
- ``{"tear": CKPT, "into": DIR, "rank": R, "step": S}``: each rank copies
  its own rank file of CKPT into DIR, and rank R marks its copy as saved
  at step S, a torn save;
- ``{"stitch": CKPT}``: rank 0 joins the rank files of CKPT into the
  gathered file CKPT beside them.

``{store}`` in an argv is STORE with the run's index appended.

    RANK=r WORLD_SIZE=K python tests/_torch_pg_faults_worker.py PLAN.json \
        STORE
"""
import json
import os
import shutil
import sys

import numpy as np
import torch

from repro_torch.checkpoint import rank_path, stitch_rank_checkpoints
from repro_torch.configs import get_arch
from repro_torch.launch import train


class Stop(Exception):
    pass


def _write(out, rank, obj):
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(obj, f)


def run(spec, rank, store):
    args = train.parse_args([a.replace("{store}", store)
                             for a in spec["argv"]])
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    records = []

    def on_step(rec):
        records.append(rec)
        if rec["step"] == spec.get("stop_after"):
            raise Stop
    try:
        train.run(cfg, args, on_step=on_step)
    except Stop:
        _write(spec["out"], rank, {"history": records})
        return
    except Exception as e:      # noqa: BLE001  (the expected raise)
        if type(e).__name__ != spec.get("expect"):
            raise
        _write(spec["out"], rank, {"error": f"{type(e).__name__}: {e}"})
        return
    if "stop_after" in spec or "expect" in spec:
        raise AssertionError(f"the run did not stop or raise: {spec}")


def tear(spec, rank):
    os.makedirs(spec["into"], exist_ok=True)
    src = rank_path(spec["tear"], rank)
    dst = os.path.join(spec["into"], os.path.basename(src))
    shutil.copyfile(src, dst)
    if rank == spec["rank"]:
        payload = dict(np.load(dst))
        payload["__step__"] = np.asarray(spec["step"], np.int64)
        np.savez(dst, **payload)


def main(plan, store):
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    with open(plan) as f:
        specs = json.load(f)
    for i, spec in enumerate(specs):
        if "tear" in spec:
            tear(spec, rank)
        elif "stitch" in spec:
            if rank == 0:
                stitch_rank_checkpoints(spec["stitch"], spec["stitch"])
        else:
            run(spec, rank, f"{store}.{i}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
    print("PASS")
