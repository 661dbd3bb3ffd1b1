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
keeps their k, v in the cache and decode reads them there.  One device:
``--data-shards`` and ``--model-shards`` above 1 raise (ROADMAP.md
Queue 1 item 8).  Runs on the card unless ``--device cpu``; with no
card it raises.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
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
    "params"}.  ``params`` (on the run's device) replaces the seeded
    init."""
    if args.data_shards * args.model_shards > 1:
        raise NotImplementedError(
            "serving on several devices (--data-shards / --model-shards > "
            "1) is not ported yet (ROADMAP.md Queue 1 item 8)")
    device = resolve_device(args.device)
    disable_tf32()
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(
            args.seed), device)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    enc = None
    if cfg.num_encoder_tokens:
        enc = rng.normal(size=(args.batch, cfg.num_encoder_tokens,
                               cfg.encoder_dim)).astype(np.float32)
    total = args.prompt_len + args.gen
    with torch.no_grad():
        batch = {"tokens": torch.from_numpy(prompt).to(device).long()}
        if enc is not None:
            batch["encoder_embeds"] = torch.from_numpy(enc).to(device)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache_len=total)
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
            logits, cache = model.decode_step(params, cache, out[-1][:, None],
                                              args.prompt_len + i)
            if args.temperature > 0:
                probs = torch.softmax(logits[:, 0] / args.temperature, -1)
                tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
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
    return {"tokens": gen, "prompt": prompt, "encoder_embeds": enc,
            "prefill_ms": prefill_ms,
            "step_ms": step_ms, "decode_s": decode_s, "params": params}


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    gen = run(cfg, args)["tokens"]
    print(gen[:, :16])
    return gen


if __name__ == "__main__":
    main()
