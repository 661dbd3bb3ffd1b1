"""chip_smoke.py's phases for the MoE, Mamba2, latent-attention and
cross-attention archs, run alone on the card: the kernels' build, then
``moe`` (moe_fwd against the CPU), ``ssd`` (ssd_chunked and mamba_fwd
against the CPU), ``train`` (mamba2-130m at seq 128 and 4096,
arctic-480b at 1 layer and 4 experts, K1 and K3 counted), ``serve``
(mamba2-130m with the 32768 prompt, arctic-480b at 2 layers,
jamba-v0.1-52b at one superblock, the f32 decode-vs-prefill gate),
``mla`` (mla_fwd and mla_decode against the CPU), ``cross``
(cross-attention against the CPU, the bf16 dtypes), ``train_mla_cross``
(deepseek-v3-671b at 1 layer, llama-3.2-vision-90b at reduced()),
``serve_mla_cross`` (deepseek-v3-671b at 1 layer with the 32768 prompt,
vision at 2 superblocks, the f32 gates) and ``pg_train`` (the trainer
under torchrun, one node per process on this card, each run against
its emulated twin, which it runs first), with each phase's seconds.  A
quicker call than the whole smoke run while iterating on these paths.

    python3 tools/chip_phases.py [moe] [ssd] [train] [serve] [mla] \
        [cross] [train_mla_cross] [serve_mla_cross] [pg_train]  # card

No names runs all nine.  Each phase prints its JSON lines as
chip_smoke does and raises as chip_smoke would.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402  (sets the allocator before torch)
import torch  # noqa: E402

PHASES = ("moe", "ssd", "train", "serve", "mla", "cross",
          "train_mla_cross", "serve_mla_cross", "pg_train")


def main(argv=None):
    names = list(argv if argv is not None else sys.argv[1:]) or PHASES
    if not torch.cuda.is_available():
        sys.exit("chip_phases: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.zeros((), device=dev)     # the allocator's stats need a context
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    from repro_torch.core.autoencoder import ENCODER_SPEC
    lgc = ["--compression", "lgc_rar", "--topk-backend", "fused",
           "--ae-backend", "pallas", "--ae-train-steps", "2"]
    run = {"moe": lambda: CS.moe_phase(dev),
           "ssd": lambda: CS.ssd_phase(dev),
           "train": lambda: CS.moe_ssm_train_runs(dev, {}, 2, lgc,
                                                  len(ENCODER_SPEC)),
           "serve": lambda: CS.serve_moe_ssm_phase(dev),
           "mla": lambda: CS.mla_phase(dev),
           "cross": lambda: CS.cross_phase(dev),
           "train_mla_cross": lambda: CS.mla_cross_train_runs(
               dev, {}, 2, lgc, len(ENCODER_SPEC)),
           "serve_mla_cross": lambda: CS.serve_mla_cross_phase(dev),
           "pg_train": lambda: CS.pg_train_phase(
               dev, {}, smi, len(CS.llama_layout(0.001).compressed),
               len(ENCODER_SPEC))}
    t0 = time.perf_counter()
    CS.build_phase(smi)
    seconds = {"build": time.perf_counter() - t0}
    for name in names:
        t = time.perf_counter()
        run[name]()
        seconds[name] = time.perf_counter() - t
    print(smi)
    print(json.dumps({"seconds": seconds, "card": smi}))


if __name__ == "__main__":
    main()
