"""One rank of tests/test_torch_pg_faults.py's stopped launch: the port's
trainer (``launch.train.run``) stopped after a given step by ``run()``'s
``on_step`` hook, which runs once that step's checkpoint is written, as a
crash right after it would stop the run.  The records of the steps it ran
go to OUT/rank<r>.json.

    RANK=r WORLD_SIZE=4 python tests/_torch_pg_stop_worker.py STEP OUT \
        [train.py arguments]
"""
import json
import os
import sys

import torch

from repro_torch.configs import get_arch
from repro_torch.launch import train


class Stop(Exception):
    pass


def main(stop_after: int, out: str, argv) -> None:
    args = train.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    records = []

    def on_step(rec):
        records.append(rec)
        if rec["step"] == stop_after:
            raise Stop
    try:
        train.run(cfg, args, on_step=on_step)
    except Stop:
        pass
    else:
        raise AssertionError(f"the run was not stopped after {stop_after}")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"rank{os.environ['RANK']}.json"), "w") as f:
        json.dump({"history": records}, f)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3:])
    print("PASS")
