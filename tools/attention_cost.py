"""What remat and flash attention cost a training step on the card: one
node's loss and gradients (``Model.loss`` + ``torch.autograd.grad``, the
work of ``launch.steps.node_grads`` for one node) of llama3.2-1b at
published widths, bf16, 4 layers, batch 4, at each sequence length, with
remat on and off, through ``models/flash.py`` or through the full-matrix
attention the port used before it (kept here only as the comparison:
(B, H, S, S) f32 scores, softmax, autograd).

    python tools/attention_cost.py [--seq 128 4096] [--reps 5]

Per variant: the host ms of 5 calls, each ending in a synchronise (their
median), the device busy ms and launches of one more call under
``torch.profiler``, and the peak GiB.  The full-matrix attention without
remat is skipped above 2048 (~8.6 GB of probabilities a layer at S 4096).
Prints one JSON line per variant, then the card's name and power limit.
Needs the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.profile import kernel_times  # noqa: E402
from repro_torch.models import flash  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.utils import disable_tf32, resolve_device  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_unflatten  # noqa: E402

FULL_MATRIX_MAX_SEQ = 2048


def full_matrix_attention(q, k, v, causal=True, window=0):
    """(B, H, S, S) f32 scores, a masked softmax and p @ v, differentiated
    by autograd (which keeps p a layer).  Causal, no window."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    p = torch.softmax(s.masked_fill(pos[:, None] < pos[None, :],
                                    float("-inf")), dim=-1)
    return (p @ vf).transpose(1, 2).to(q.dtype)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", type=int, nargs="+", default=[128, 4096])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    disable_tf32()
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), n_layers=4)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    attention = {"flash": flash.flash_attention,
                 "full_matrix": full_matrix_attention}
    try:
        for seq in args.seq:
            gen = torch.Generator(device=dev).manual_seed(1)
            tok = torch.randint(0, cfg.vocab_size, (4, seq + 1), device=dev,
                                generator=gen)
            batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
            for name, fn in attention.items():
                for remat in (True, False):
                    if (name == "full_matrix" and not remat
                            and seq > FULL_MATRIX_MAX_SEQ):
                        continue
                    flash.flash_attention = fn   # what attention_fwd calls

                    def step():
                        leaves = [p.detach().requires_grad_(True)
                                  for p in tree_leaves(params)]
                        loss, _ = model.loss(tree_unflatten(params, leaves),
                                             batch, remat=remat)
                        return torch.autograd.grad(loss, leaves)
                    step()
                    step()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    ms = []
                    for _ in range(args.reps):
                        t0 = time.perf_counter()
                        grads = step()
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                        del grads
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        grads = step()
                        torch.cuda.synchronize()
                    del grads
                    kernels = kernel_times(prof)
                    print(json.dumps({
                        "seq": seq, "batch": 4, "n_layers": 4,
                        "attention": name, "remat": remat,
                        "ms_median": sorted(ms)[len(ms) // 2], "ms": ms,
                        "device_busy_ms": sum(k[1] for k in kernels),
                        "launches": sum(k[2] for k in kernels),
                        "peak_gib": torch.cuda.max_memory_allocated(dev)
                        / 2 ** 30}), flush=True)
    finally:
        flash.flash_attention = attention["flash"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
