"""Serving entry point of the port: batched prefill, then a decode loop
on the KV cache.  Counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama3.2-1b --smoke --batch 4 --prompt-len 64 --gen 32 \
        [--device cpu]

The prompt is ``--batch`` rows of ``--prompt-len`` tokens drawn by numpy
from ``--seed``, as the reference draws them; the weights come from
``torch.Generator(seed)`` (not the reference's ``jax.random`` key).
Prefill allocates the cache at its full capacity, prompt + ``--gen``, so
decode extends it in place.  Greedy decoding is the default; with
``--temperature`` > 0 each token is sampled from softmax(logits / T)
with a ``torch.Generator`` seeded by ``--seed``, so the sampled tokens
cannot equal the reference's ``jax.random.categorical`` draws (the
greedy ones can).  The first generated token is prefill's argmax in
both modes, as in the reference.  An arch with cross-attention blocks
(llama-3.2-vision-90b) reads encoder embeddings (batch,
num_encoder_tokens, encoder_dim) f32 ~ N(0, 1), drawn by the same numpy
generator after the prompt, as the reference draws them; the prefill
keeps their k, v in the cache and decode reads them there.  Runs on the
card unless ``--device cpu``; with no card it raises.

Under torchrun (``--dist-backend gloo|nccl``) the world is the (data,
model) mesh of ``--data-shards`` x ``--model-shards`` processes, and
prefill and decode run through ``launch.steps.make_prefill_step`` and
``make_decode_step``: the heads, the FFN's hidden dim and the vocabulary
split over ``model``; the batch split over ``data`` when it divides and
is > 1 (each process decodes its rows, the logits gathered), else the
cache split along the sequence over ``data`` (each process's partial
softmax combined).  Every process computes the same greedy tokens; rank 0
prints them.  A sampled token is drawn on rank 0 and broadcast.  Outside
torchrun more than one shard raises.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --data-shards 2 --model-shards 2 \
        --dist-backend gloo --smoke --device cpu
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.dist.tp import Group
from repro_torch.launch.mesh import init_process_mesh, under_torchrun
from repro_torch.launch.steps import (held_bytes, init_held,
                                      make_decode_step, make_prefill_step,
                                      shard_params)
from repro_torch.models.model import build_model
from repro_torch.utils import disable_tf32, resolve_device

log = logging.getLogger("repro_torch.serve")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--data-shards", type=int, default=1)
    p.add_argument("--model-shards", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                   help="under torchrun: the process group's backend")
    p.add_argument("--dist-init", default="env://",
                   help="under torchrun: the process group's rendezvous")
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ModelConfig, args, params=None) -> Dict[str, Any]:
    """Serve ``cfg`` as ``args`` says.  Returns {"tokens": (B, gen) int32
    numpy, the generated tokens; "prompt": (B, prompt_len) int32 numpy;
    "encoder_embeds": (B, T, encoder_dim) f32 numpy or None;
    "prefill_ms"; "step_ms": host ms of each decode step, each ending in
    a synchronise on the card; "decode_s": the decode loop's seconds;
    "params"; "logits": the last decode step's (B, 1, V) f32 numpy
    (prefill's when ``--gen`` is 1); under torchrun "held": this
    process's parameter and cache bytes, and "peak_gib"}.
    ``params`` (whole, on the run's device) replaces the seeded init;
    under torchrun the processes draw the seeded init in turn, each
    keeping its block (``launch.steps.init_held``)."""
    shards = args.data_shards * args.model_shards
    if not under_torchrun():
        if args.dist_backend:
            raise ValueError("--dist-backend is for a run under torchrun")
        if shards > 1:
            raise ValueError(
                f"--data-shards {args.data_shards} x --model-shards "
                f"{args.model_shards} needs one process a shard: launch it "
                f"under torchrun (python -m torch.distributed.run "
                f"--nproc-per-node {shards} ...)")
        return _serve(cfg, args, params, resolve_device(args.device), None)
    grid = init_process_mesh((args.data_shards,), args.dist_backend,
                             args.device, args.dist_init,
                             model=args.model_shards)
    try:
        return _serve(cfg, args, params, grid.device, grid)
    finally:
        dist.destroy_process_group()


def _serve(cfg, args, params, device, grid) -> Dict[str, Any]:
    disable_tf32()
    model = build_model(cfg)
    if params is None and grid is None:
        params = model.init(torch.Generator(device=device).manual_seed(
            args.seed), device)
    total = args.prompt_len + args.gen
    prefill, decode = model.prefill, model.decode_step
    world = None
    if grid is not None:
        shape = InputShape("serve_decode", total, args.batch, "decode")
        prefill, lay = make_prefill_step(model, grid, shape)
        decode, _ = make_decode_step(model, grid, shape)
        params = init_held(model, args.seed, device, lay.pspecs, grid) \
            if params is None else shard_params(params, lay.pspecs, grid)
        if args.temperature > 0:
            world = Group(range(grid.spec.size), None, device)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    enc = None
    if cfg.num_encoder_tokens:
        enc = rng.normal(size=(args.batch, cfg.num_encoder_tokens,
                               cfg.encoder_dim)).astype(np.float32)
    with torch.no_grad():
        batch = {"tokens": torch.from_numpy(prompt).to(device).long()}
        if enc is not None:
            batch["encoder_embeds"] = torch.from_numpy(enc).to(device)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cache_len=total)
        out = [logits[:, -1].argmax(-1)]
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        log.info("prefill(%d tokens x %d) %.2f ms", args.prompt_len,
                 args.batch, prefill_ms)
        sampler = torch.Generator(device=device).manual_seed(args.seed)
        step_ms = []
        t_loop = time.perf_counter()
        for i in range(args.gen - 1):
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, out[-1][:, None],
                                   args.prompt_len + i)
            if args.temperature > 0:
                probs = torch.softmax(logits[:, 0] / args.temperature, -1)
                tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
                if world is not None:
                    tok = world.broadcast(tok, 0)     # rank 0's draw
            else:
                tok = logits[:, 0].argmax(-1)
            out.append(tok)
            _sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        decode_s = time.perf_counter() - t_loop
    gen = torch.stack(out, 1).to(torch.int32).cpu().numpy()
    # the loop decodes gen - 1 tokens a sequence: prefill gave the first
    log.info("decoded %d x %d tokens in %.2fs (%.1f tok/s)", args.batch,
             args.gen - 1, decode_s,
             args.batch * (args.gen - 1) / max(decode_s, 1e-9))
    res = {"tokens": gen, "prompt": prompt, "encoder_embeds": enc,
           "prefill_ms": prefill_ms,
           "step_ms": step_ms, "decode_s": decode_s, "params": params,
           "logits": logits.cpu().numpy()}
    if grid is not None:
        res["held"] = {"params": held_bytes(params),
                       "cache": held_bytes(cache)}
        res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
            if device.type == "cuda" else None
    return res


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    gen = run(cfg, args)["tokens"]
    if not under_torchrun() or os.environ["RANK"] == "0":
        print(gen[:, :16])
    return gen


if __name__ == "__main__":
    main()
