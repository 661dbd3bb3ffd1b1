"""Time variants of the K6, K1 and K3 kernels on the card: what each part
costs.

    PYTHONPATH=src python tools/kernel_variants.py [name ...]

Each variant is the kernel's source with a few text substitutions (each must
still match the current source: tests/test_torch_kernel_variants.py checks
that on the CPU), compiled into its own library under ``build/variants/``
and launched through the same
C entry point, at the main path's shapes: the block top-k at the llama3.2-1b
(4 layers, alpha = 0.001) MLP, attention-output and key/value leaf blocks,
the fused EF sweep at that layout's flat gradient (506M elements, 131072
blocks), the encoder matmul at its five im2col shapes.  Variants marked
"timing only" change what the kernel computes (they drop or fake a part of
it), so their outputs are not compared; the others are held to the plain
version as chip_smoke.py holds the kernels.  Prints one JSON line per variant (device
ms per shape) and one for the library call at the same shapes.  Needs the
card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import block_topk as BT
from repro_torch.kernels import build
from repro_torch.kernels import matmul_lrelu as MM
from repro_torch.kernels import segmented_topk as ST
from repro_torch.kernels import sparsify_ef as EF

OUT = build.BUILD_DIR.parent / "variants"
K6_SHAPES = [(999, 67200, 67109), (993, 16896, 16777), (512, 8192, 4194)]
K3_SHAPES = [(121648, 3, 64), (60824, 192, 128), (30412, 384, 256),
             (15206, 768, 64), (15206, 64, 4)]

_WRITE = "      store(s.tile_dst[digit<KEY_LO>(w, pass)] + k, w);"
_PASSES = ("  radix::row_pass<LOC_BITS>(keys, wa, block, 0, s);\n"
           "  radix::row_pass<LOC_BITS>(wa, wb, block, 1, s);\n"
           "  radix::row_pass<LOC_BITS>(wb, wc, block, 2, s);\n"
           "  radix::row_pass<LOC_BITS>(wc, out, block, 3, s);")
_PEERS = ("  if (valid) atomicOr(&peer_bits[d], 1u << lane);\n"
          "  __syncwarp();\n"
          "  const unsigned peers =\n"
          "      valid ? *static_cast<volatile unsigned*>"
          "(&peer_bits[d]) : 0u;")
_SPLIT = ("  hi = (__float_as_uint(x) + TF32_HALF_ULP) & TF32_MASK;\n"
          "  const float r = x - __uint_as_float(hi);\n"
          "  bad |= !(fabsf(r) < __int_as_float(0x7F800000));\n"
          "  lo = __float_as_uint(r);")
_NOLOAD = [("    if (st < n_k) load(st, st);",
            "    if (st < n_k && K < 0) load(st, st);"),
           ("    if (kt + STAGES - 1 < n_k)\n      load(",
            "    if (kt + STAGES - 1 < n_k && K < 0)\n      load(")]

_NO_WALK = ("rb, base, len, lo, hi, budget,", "rb, base, len, lo, hi, 0,")
_SWEEP_PASSES = ("  radix::row_pass<LOC_BITS>(keys, wa, len, 0, s.r);\n"
                 "  radix::row_pass<LOC_BITS>(wa, wb, len, 1, s.r);\n"
                 "  radix::row_pass<LOC_BITS>(wb, wc, len, 2, s.r);\n"
                 "  radix::row_pass<LOC_BITS>(wc, locs, len, 3, s.r);")

# name: (source, [(old, new)], timing only)
VARIANTS = {
    "k6": ("block_topk", [], False),
    "k6 histogram only": ("block_topk", [(_PASSES, "")], True),
    "k6 no global writes": ("block_topk", [
        (_WRITE, "      if (w == 12345ULL) store(k, w);")], True),
    "k6 contiguous writes": ("block_topk", [
        (_WRITE, "      store(tile0 + k, w);")], True),
    "k6 digit runs x2": ("block_topk", [
        (_WRITE, "      { const int d = digit<KEY_LO>(w, pass) & ~1;\n"
                 "        store(s.tile_dst[d] + k, w); }")], True),
    "k6 peers by __match_any_sync": ("block_topk", [
        (_PEERS, "  const unsigned peers = __match_any_sync(FULL, d)"
                 " & __ballot_sync(FULL, valid);")], False),
    "k6 no prefetch": ("block_topk", [
        ("  fetch_tile(load, 0, n, s);\n"
         "  for (int tile0 = 0; tile0 < n; tile0 += TILE) {\n"
         "    wait_tile();",
         "  for (int tile0 = 0; tile0 < n; tile0 += TILE) {\n"
         "    fetch_tile(load, tile0, n, s);\n"
         "    wait_tile();"),
        ("    if (tile0 + TILE < n) fetch_tile(load, tile0 + TILE, n, s);\n",
         "")], False),
    "k6 256 threads, 32 items": ("block_topk", [
        ("constexpr int THREADS = 2 * BINS;", "constexpr int THREADS = BINS;"),
        ("constexpr int ITEMS = 16;", "constexpr int ITEMS = 32;"),
        ("__launch_bounds__(radix::THREADS, 1)",
         "__launch_bounds__(radix::THREADS, 2)")], False),
    "k1": ("sparsify_ef", [], False),
    "k1 fill one CTA a block": ("sparsify_ef", [
        ("constexpr int FILL_SLICES = 8;", "constexpr int FILL_SLICES = 1;")],
        False),
    "k1 no cap walk": ("sparsify_ef", [_NO_WALK], True),
    "k1 histogram only": ("sparsify_ef", [_NO_WALK, (_SWEEP_PASSES, "")],
                          True),
    "k1 no fill kernel": ("sparsify_ef", [
        ("  inactive_kernel<Src><<<",
         "  if (n < 0) inactive_kernel<Src><<<")], True),
    "k1 cap walk without gathers": ("sparsify_ef", [
        ("      sl[j] = i < len ? __ldg(seg + base + loc[j]) : -1;",
         "      sl[j] = i < len ? lo : -1;"),
        ("        cv[pos] = src.value(gi);", "        cv[pos] = 0.f;")],
        True),
    "k3": ("matmul_lrelu", [], False),
    "k3 exact split always": ("matmul_lrelu", [
        ("        if (!__any_sync(0xffffffffu, bad)) {",
         "        if (bad && !bad) {")], False),
    "k3 no split": ("matmul_lrelu", [
        (_SPLIT, "  hi = lo = __float_as_uint(x);")], True),
    "k3 no loads": ("matmul_lrelu", _NOLOAD, True),
    "k3 no mma": ("matmul_lrelu", [("      if (ks < steps) {",
                                    "      if (ks < steps && K < 0) {")],
                  True),
}


def variant_sources(name):
    """{file name: text}: the kernel's source and the headers with the
    variant's substitutions made; raises if one no longer matches."""
    src, subs, _ = VARIANTS[name]
    files = {f.name: f.read_text() for f in
             [*build.CSRC.glob("*.cuh"), build.CSRC / f"{src}.cu"]}
    for old, new in subs:
        hits = [n for n, text in files.items() if old in text]
        if not hits:
            raise ValueError(f"{name}: {old[:60]!r} not in the source")
        for n in hits:
            files[n] = files[n].replace(old, new)
    return files


def compile_variants(names):
    """{name: (CDLL, source)}; one nvcc per variant, started together."""
    procs = {}
    for name in names:
        src = VARIANTS[name][0]
        d = OUT / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for n, text in variant_sources(name).items():
            (d / n).write_text(text)
        lib = d / f"lib{src}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(d / f"{src}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib, src)
    libs = {}
    for name, (proc, lib, src) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in build.SIGNATURES[src].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = (cdll, src)
    return libs


def cuda_ms(fn, reps):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_inputs(dev, gen):
    """K1 at the main path's layout: (plain version's args, outputs,
    the C entry point's arguments up to the stream)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core import sparsify as SP
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), n_layers=4)
    layout = SP.build_layout(build_model(cfg).init(torch.Generator(),
                                                   "meta"), 0.001)
    _, block, seg, kcap, n_cand, _ = SP._fused_meta(
        layout, (SP.ROLE_COMPRESSED, SP.ROLE_TOPK_ONLY), "auto")
    n = layout.n_total
    nb = -(-n // block)
    g, u, v = (torch.randn(n, generator=gen, device=dev) * 1e-3
               for _ in range(3))
    seg, kcap = (torch.from_numpy(a).to(dev) for a in (seg, kcap))
    active = ST.active_blocks(seg, block)
    outs = (torch.empty_like(g), torch.empty_like(g),
            torch.empty((nb * n_cand,), device=dev),
            torch.empty((nb * n_cand,), dtype=torch.int32, device=dev),
            torch.empty((nb * n_cand,), dtype=torch.int32, device=dev))
    a, b = ST.radix_scratch(active, block)
    ptrs = ([t.data_ptr() for t in (g, u, v, seg, kcap, active)]
            + [kcap.numel()] + [t.data_ptr() for t in outs + (a, b)]
            + [n, block, nb, n_cand, 0.9, 1])
    return (g, u, v, seg, kcap, 0.9, True, n_cand, block), outs, ptrs


def main(names) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    k6_in = {s: torch.randn(s[:2], generator=gen, device=dev) * 1e-3
             for s in K6_SHAPES}
    k3_in = {}
    for M, K, N in K3_SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev) * 0.1
        w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
        b = torch.randn((N,), generator=gen, device=dev) * 0.1
        k3_in[(M, K, N)] = (x, w, b, MM.matmul_bias_lrelu_plain(x, w, b))
    k1_in = None
    if any(VARIANTS[nm][0] == "sparsify_ef" for nm in names):
        k1_in = k1_inputs(dev, gen)
    for name, (lib, src) in compile_variants(names).items():
        timing_only = VARIANTS[name][2]
        row = {}
        if src == "sparsify_ef":
            args, outs, ptrs = k1_in

            def call():
                build.check(lib.fused_ef_topk(*ptrs, stream), name)
            call()
            torch.cuda.synchronize()
            if not timing_only:
                want = EF.sparsify_ef_topk_plain(*args)
                assert all(torch.equal(a, b) for a, b in zip(outs, want)), \
                    name
                del want
            row["llama3.2-1b 4 layers, alpha 0.001"] = cuda_ms(call, 5)
        elif src == "block_topk":
            for nb, block, kb in K6_SHAPES:
                x = k6_in[(nb, block, kb)]
                vals = torch.empty((nb, kb), device=dev)
                idx = torch.empty((nb, kb), dtype=torch.int32, device=dev)
                a = torch.empty((nb * block,), dtype=torch.int64,
                                device=dev)
                b = torch.empty((nb * block,), dtype=torch.int32,
                                device=dev)

                def call():
                    build.check(lib.block_topk(
                        x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                        a.data_ptr(), b.data_ptr(), nb, block, kb, stream),
                        name)
                call()
                torch.cuda.synchronize()
                if not timing_only:
                    want = BT.block_topk_plain(x, kb)
                    assert torch.equal(vals, want[0]) and \
                        torch.equal(idx, want[1]), (name, block)
                row[f"{nb}x{block}"] = cuda_ms(call, 5)
        else:
            for M, K, N in K3_SHAPES:
                x, w, b, yp = k3_in[(M, K, N)]
                y = torch.empty((M, N), device=dev)

                def call():
                    build.check(lib.matmul_bias_lrelu(
                        x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        y.data_ptr(), M, N, K, 1, stream), name)
                call()
                torch.cuda.synchronize()
                if not timing_only:
                    tol = 1e-5 * max(1.0, float(yp.abs().max()))
                    assert float((y - yp).abs().max()) <= tol, (name, M)
                row[f"{M}x{K}x{N}"] = cuda_ms(call, 50)
            row["sum"] = sum(row.values())
        print(json.dumps({"variant": name, "timing_only": timing_only,
                          "ms": row}), flush=True)
    lib_ms = {}
    for nb, block, kb in K6_SHAPES:
        mag = k6_in[(nb, block, kb)].abs()
        lib_ms[f"{nb}x{block}"] = cuda_ms(lambda: torch.topk(mag, kb, dim=1),
                                          3)
    for (M, K, N), (x, w, b, _) in k3_in.items():
        lib_ms[f"{M}x{K}x{N}"] = cuda_ms(
            lambda: F.leaky_relu(torch.addmm(b, x, w), 0.01), 50)
    print(json.dumps({"variant": "library (torch.topk of |x|; addmm + "
                      "leaky_relu)", "ms": lib_ms}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
