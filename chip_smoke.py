"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout (logs go to stderr):

  1. build    compile every CUDA kernel from the sources in this checkout
              (one nvcc per source, started together) into build/kernels/
  2. k1       the fused EF + segmented top-k sweep kernel against its plain
              PyTorch version on the same inputs, bitwise, at llama3.2-1b's
              full-width flat-gradient layout (4 layers): alpha = 0.001,
              where "auto" resolves the bitonic rule (128Ki blocks), and
              alpha = 0.0001, where it resolves the loop rule
  3. k3       the fused matmul + bias + LeakyReLU kernel against its plain
              version at the AE encoder's five im2col shapes for that
              layout's mu_pad, within |err| <= 1e-5 * max(1, max|y|)
  4. train    repro_torch.launch.train's run(): llama3.2-1b at published
              widths (d_model 2048, 32/8 heads, d_ff 8192, vocab 128256,
              bf16) with n_layers cut from 16 to 4, lgc_rar with the fused
              sweep and the kernel encoder, K=2 nodes on this card,
              6 steps through all three phases; launch counts, finite
              losses and per-op wire-byte rows are checked
  5. timings  each kernel's ms beside its plain version's, its bound and
              (K3) one PyTorch call computing the same function

then the kernel list, the card's name and power limit, and on the last
line {"ok": true, "device": {...}}.  Any failed check raises: the script
exits non-zero and prints no result.  Without a CUDA device it refuses.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
N_LAYERS = 4                       # the only cut: 16 -> 4 layers


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over ``reps`` runs after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_phase(card: str):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    emit("build", card=card, seconds=time.perf_counter() - t0,
         nvcc={k: v["seconds"] for k, v in report.items()},
         ptxas={k: v["ptxas"] for k, v in report.items()})


def llama_layout(sparsity: float):
    from repro_torch.configs import get_arch
    from repro_torch.core import sparsify as SP
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), n_layers=N_LAYERS)
    meta = build_model(cfg).init(torch.Generator(), "meta")
    return SP.build_layout(meta, sparsity)


def k1_phase(dev):
    """Kernel vs plain, bitwise, at both block rules; times at alpha=0.001
    (the main path's layout)."""
    from repro_torch.core import sparsify as SP
    from repro_torch.kernels import sparsify_ef as EF
    roles = (SP.ROLE_COMPRESSED, SP.ROLE_TOPK_ONLY)
    gen = torch.Generator(device=dev).manual_seed(0)
    timing = None
    for sparsity, rule in ((0.001, "bitonic"), (0.0001, "loop")):
        layout = llama_layout(sparsity)
        ex, block, seg, kcap, n_cand, _ = SP._fused_meta(layout, roles,
                                                         "auto")
        assert ex == rule, (sparsity, ex)
        n = layout.n_total
        g, u, v = (torch.randn(n, generator=gen, device=dev) * 1e-3
                   for _ in range(3))
        seg_t = torch.from_numpy(seg).to(dev)
        kcap_t = torch.from_numpy(kcap).to(dev)
        active = EF.active_blocks(seg_t, block)
        args = (g, u, v, seg_t, kcap_t, 0.9, True, n_cand, block)
        out_k = EF.sparsify_ef_topk(*args, active=active)
        torch.cuda.synchronize()
        out_p = EF.sparsify_ef_topk_plain(*args)
        names = ("u", "v", "cand_vals", "cand_idx", "cand_seg")
        equal = {nm: bool(torch.equal(a, b))
                 for nm, a, b in zip(names, out_k, out_p)}
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(out_k, out_p))
        kept = int((out_k[4] >= 0).sum())
        emit("k1", extract=ex, block=block, n=n, n_cand=n_cand,
             n_blocks=out_k[2].numel() // n_cand, kept=kept,
             bitwise=equal, max_abs_err=err)
        if not all(equal.values()):
            raise AssertionError(f"fused_ef_topk differs from its plain "
                                 f"version at {ex}: {equal}")
        if timing is None:
            del out_k, out_p
            ms = cuda_ms(lambda: EF.sparsify_ef_topk(*args, active=active), 3)
            plain_ms = cuda_ms(lambda: EF.sparsify_ef_topk_plain(*args), 1)
            pool = (-(-n // block)) * n_cand
            nbytes = n * (4 * 3 + 4) + n * 4 * 2 + pool * 12
            timing = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                      "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S
                      * 1e3, "bound_by": "bytes", "library_ms": None,
                      "block": block, "n": n, "n_cand": n_cand}
        del g, u, v, seg_t, active, args
        torch.cuda.empty_cache()
    return timing


def k3_phase(dev):
    """Kernel vs plain at the encoder's im2col shapes for the main path's
    mu_pad; times one encoder pass (five launches)."""
    import torch.nn.functional as F
    from repro_torch.core import autoencoder as AE
    from repro_torch.kernels import matmul_lrelu as MM
    from repro_torch.kernels import ops
    mu_pad = llama_layout(0.001).mu_pad
    gen = torch.Generator(device=dev).manual_seed(1)
    ae = AE.init_lgc_autoencoder(gen, dev)
    x = torch.randn((mu_pad, 1), generator=gen, device=dev) * 1e-3
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0, "bound_ms": 0.0}
    err, shapes = 0.0, []
    for p, (_c, k, s) in zip(ae["encoder"], AE.ENCODER_SPEC):
        cols = ops._im2col_1d(x, k, s).contiguous()
        w = p["w"].reshape(-1, p["w"].shape[-1]).contiguous()
        b = torch.randn(p["b"].shape, generator=gen, device=dev) * 0.1
        y = MM.matmul_bias_lrelu(cols, w, b)
        torch.cuda.synchronize()
        yp = MM.matmul_bias_lrelu_plain(cols, w, b)
        e = float((y - yp).abs().max())
        tol = 1e-5 * max(1.0, float(yp.abs().max()))
        if e > tol:
            raise AssertionError(f"matmul_bias_lrelu off by {e} > {tol} at "
                                 f"{tuple(cols.shape)} @ {tuple(w.shape)}")
        err = max(err, e)
        (M, Kd), N = cols.shape, w.shape[1]
        t = {"ms": cuda_ms(lambda: MM.matmul_bias_lrelu(cols, w, b), 20),
             "plain_ms": cuda_ms(lambda: MM.matmul_bias_lrelu_plain(
                 cols, w, b), 20),
             "library_ms": cuda_ms(lambda: F.leaky_relu(
                 torch.addmm(b, cols, w), 0.01), 20),
             "bytes_ms": (M * Kd + Kd * N + N + M * N) * 4
             / HBM_BYTES_PER_S * 1e3,
             "ops_ms": 2.0 * M * N * Kd / F32_FLOPS * 1e3}
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        for key in tot:
            tot[key] += t[key]
        shapes.append({"M": M, "K": Kd, "N": N, "max_abs_err": e,
                       "tol": tol, **t})
        x = y
    emit("k3", mu_pad=mu_pad, shapes=shapes, max_abs_err=err)
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] \
        else "operations"
    tot["max_abs_err"] = err
    return tot


def train_phase(dev):
    from repro_torch.configs import get_arch
    from repro_torch.dist import plan as XP
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), n_layers=N_LAYERS)
    args = train.parse_args([
        "--compression", "lgc_rar", "--topk-backend", "fused",
        "--ae-backend", "pallas", "--data-shards", "2", "--batch", "8",
        "--seq", "128", "--warmup-steps", "2", "--ae-train-steps", "2",
        "--steps", "6", "--log-every", "1", "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = train.run(cfg, args)
    launches = dict(LAUNCHES)
    hist, comp = out["history"], out["compressor"]
    losses = [h["loss"] for h in hist]
    if not all(map(lambda l: l == l and abs(l) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    for name in ("fused_ef_topk", "matmul_bias_lrelu"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the main path: "
                                 f"{launches}")
    for phase, rows in out["wire"].items():
        plan = XP.build_plan(comp.cc, comp.layout, comp.K, transport="mesh",
                             phase=phase)
        if rows != XP.wire_terms_by_op(plan):
            raise AssertionError(f"{phase}: measured wire rows {rows} != "
                                 f"priced {XP.wire_terms_by_op(plan)}")
    step_ms = {}
    for h in hist:
        step_ms.setdefault(h["phase"], []).append(h["ms"])
    emit("train", arch=cfg.name, n_layers=N_LAYERS, reduced=["n_layers"],
         d_model=cfg.d_model, dtype=cfg.dtype, n_params=comp.layout.n_total,
         nodes=comp.K, losses=losses, step_ms=step_ms, launches=launches,
         wire=out["wire"], peak_mem_gib=torch.cuda.max_memory_allocated(dev)
         / 2 ** 30, rate_bytes_per_node=out["rate"].bytes_per_node)
    return launches


def main() -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit("chip_smoke: run from a checkout of the repository")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    build_phase(smi)
    k1 = k1_phase(dev)
    k3 = k3_phase(dev)
    torch.cuda.empty_cache()
    launches = train_phase(dev)
    emit("timings", card=smi, fused_ef_topk=k1, matmul_bias_lrelu=k3)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": "fused_ef_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparsify_ef.cu",
         "replaces": "src/repro/kernels/sparsify_ef.py:117",
         "launches": launches["fused_ef_topk"],
         **{k: k1[k] for k in keys}},
        {"name": "matmul_bias_lrelu", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_lrelu.cu",
         "replaces": "src/repro/kernels/matmul_lrelu.py:46",
         "launches": launches["matmul_bias_lrelu"],
         **{k: k3[k] for k in keys}}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
