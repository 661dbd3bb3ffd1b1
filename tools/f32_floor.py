"""How far one f32 evaluation lies from an f64 one, for the chunked SSD
scan, the MoE layer, latent attention and cross-attention at their
published widths: the output and every gradient of sum(y * r) (+ the aux
loss), each as the largest |f32 - f64| over the largest |f64|.  Two f32
evaluations that sum in another order (the card against the CPU, the
port against the reference) differ by about as much, so this is the
floor under any tolerance that compares them.  Runs on the CPU, or with
``--device cuda`` on the card (f64 at full rate there; TF32 off).

    PYTHONPATH=src python tools/f32_floor.py ssd [--seq 2048 4097]
    PYTHONPATH=src python tools/f32_floor.py moe [--experts 4 --tokens 128]
    PYTHONPATH=src python tools/f32_floor.py mla [--seq 512 1025]
    PYTHONPATH=src python tools/f32_floor.py cross [--seq 512]

ssd: mamba2-130m's scan (24 heads of 64, d_state 128, chunk 256), batch
1, from numpy seed 0: dt = softplus(N(0, 1)), A = -exp(U[0, log 16]) as
the reference draws its decay, x, B, C, D ~ N(0, 1).  moe: arctic-480b's
widths (d_model 7168, d_ff_expert 4864, the dense residual), ``--experts``
experts drawn with the std of ``--std-experts`` (the reference's
1/sqrt(E) scale; default 8, chip_smoke's moe phase), ``--tokens``
tokens; its router and norms compute in f32 in both runs, as the
layer's code says.  mla: deepseek-v3-671b's latent attention (d_model
7168, 128 heads, q_lora 1536, kv_lora 512, nope 128, rope 64, v 128),
batch 2, seeded weights: mla_fwd's output, its cache (c_kv, k_rope) and
every gradient of sum(y * r) + sum(c_kv * rc) + sum(k_rope * rk); and
the absorbed decode (3 steps after a prefill of S - 3 tokens, f32)
against the expanded form over all S tokens in f64.  cross:
llama-3.2-vision-90b's cross-attention (d_model 8192, 64 / 8 heads of
128, 1601 encoder tokens of 1280), batch 2, its gate at 0.5: the output
and every gradient, the gate's and the embeddings' included.  The
layers' norms and rope compute in f32 in both runs, as their code says.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


def _rel(lo, hi) -> float:
    return float((lo.double() - hi.double()).abs().max()
                 / hi.double().abs().max())


def ssd(a) -> dict:
    from repro_torch.models.mamba2 import ssd_chunked
    out = {}
    for S in a.seq:
        r = np.random.default_rng(0)
        args = [r.standard_normal((1, S, a.heads, a.head_dim)),
                np.log1p(np.exp(r.standard_normal((1, S, a.heads)))),
                -np.exp(r.uniform(0.0, np.log(16.0), a.heads)),
                r.standard_normal((1, S, a.d_state)),
                r.standard_normal((1, S, a.d_state)),
                r.standard_normal(a.heads)]
        cot = np.random.default_rng(1).standard_normal(args[0].shape)

        def run(dtype):
            ts = [torch.tensor(x, dtype=dtype).requires_grad_(True)
                  for x in args]
            y = ssd_chunked(*ts, chunk=a.chunk)
            g = torch.autograd.grad((y * torch.tensor(cot, dtype=dtype))
                                    .sum(), ts)
            return [y.detach()] + list(g)

        names = ("y", "dx", "ddt", "dA", "dB", "dC", "dD")
        out[f"S {S}"] = {n: _rel(lo, hi) for n, lo, hi in zip(
            names, run(torch.float32), run(torch.float64))}
    return out


def moe(a) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.utils.tree import (keystr_path, tree_leaves_with_path,
                                        tree_unflatten)
    base = get_arch("arctic-480b")
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, num_experts=a.experts))
    gen = torch.Generator().manual_seed(0)
    p = L.init_moe(gen, cfg, torch.float32, "cpu")
    for n in ("w_gate", "w_up", "w_down"):
        p[n].mul_((a.experts / a.std_experts) ** 0.5)
    x = torch.randn(1, a.tokens, cfg.d_model, generator=gen)
    cot = torch.randn(x.shape, generator=gen)
    names = ["y"] + ["d" + keystr_path(q)
                     for q, _ in tree_leaves_with_path(p)] + ["dx"]

    def run(dtype):
        # the router's weight stays f32, as the layer keeps it
        leaves = [(t if q[0] == "router" else t.to(dtype)).requires_grad_(
            True) for q, t in tree_leaves_with_path(p)]
        xx = x.to(dtype).requires_grad_(True)
        y, aux = L.moe_fwd(tree_unflatten(p, leaves), cfg, xx)
        g = torch.autograd.grad((y * cot.to(dtype)).sum() + aux,
                                leaves + [xx])
        return [y.detach()] + list(g)

    return {n: _rel(lo, hi) for n, lo, hi in zip(
        names, run(torch.float32), run(torch.float64))}


def _leaves_run(p, dtype):
    from repro_torch.utils.tree import tree_leaves
    return [t.to(dtype).detach().requires_grad_(True)
            for t in tree_leaves(p)]


def mla(a) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.utils import disable_tf32
    from repro_torch.utils.tree import (keystr_path, tree_leaves_with_path,
                                        tree_unflatten)
    disable_tf32()
    dev = torch.device(a.device)
    cfg = dataclasses.replace(get_arch("deepseek-v3-671b"), dtype="float32")
    m = cfg.mla
    gen = torch.Generator(device=dev).manual_seed(0)
    p = L.init_mla(gen, cfg, torch.float32, dev)
    names = ["y", "c_kv", "k_rope"] + ["d" + keystr_path(q) for q, _ in
                                        tree_leaves_with_path(p)] + ["dx"]
    out = {}
    for S in a.seq:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(2, S, cfg.d_model)
        cots = [randn(2, S, cfg.d_model), randn(2, S, m.kv_lora_rank),
                randn(2, S, m.qk_rope_head_dim)]

        def run(dtype):
            leaves = _leaves_run(p, dtype)
            xx = x.to(dtype).requires_grad_(True)
            y, (c, k) = L.mla_fwd(tree_unflatten(p, leaves), cfg, xx,
                                  torch.arange(S, device=dev))
            obj = sum((t * r.to(dtype)).sum() for t, r in zip((y, c, k),
                                                              cots))
            g = torch.autograd.grad(obj, leaves + [xx])
            return [y.detach(), c.detach(), k.detach()] + list(g)

        lo, hi = run(torch.float32), run(torch.float64)
        rel = {n: _rel(a_, b_) for n, a_, b_ in zip(names, lo, hi)}
        del lo
        # the absorbed decode (f32) after a prefill of S - 3 tokens,
        # against the expanded form over all S tokens in f64
        P = S - 3
        with torch.no_grad():
            cache = L.init_mla_cache(cfg, 2, S, torch.float32, dev)
            _, (c, k) = L.mla_fwd(p, cfg, x[:, :P], torch.arange(P,
                                                                 device=dev))
            cache["c_kv"][:, :P], cache["k_rope"][:, :P] = c, k
            cache["pos"][:P] = torch.arange(P, dtype=torch.int32, device=dev)
            dec = torch.cat([L.mla_decode(p, cfg, x[:, i:i + 1], cache, i)[0]
                             for i in range(P, S)], 1)
        rel["decode_absorbed"] = _rel(dec, hi[0][:, P:])
        out[f"S {S}"] = rel
        del hi
    return out


def cross(a) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.utils import disable_tf32
    from repro_torch.utils.tree import (keystr_path, tree_leaves_with_path,
                                        tree_unflatten)
    disable_tf32()
    dev = torch.device(a.device)
    cfg = dataclasses.replace(get_arch("llama-3.2-vision-90b"),
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = L.init_cross_attention(gen, cfg, torch.float32, dev)
    p["gate"].fill_(a.gate)
    names = ["y"] + ["d" + keystr_path(q) for q, _ in
                     tree_leaves_with_path(p)] + ["dx", "denc"]
    out = {}
    for S in a.seq:
        x = torch.randn((2, S, cfg.d_model), generator=gen, device=dev)
        enc = torch.randn((2, cfg.num_encoder_tokens, cfg.encoder_dim),
                          generator=gen, device=dev)
        cot = torch.randn(x.shape, generator=gen, device=dev)

        def run(dtype):
            leaves = _leaves_run(p, dtype)
            xx, ee = (t.to(dtype).requires_grad_(True) for t in (x, enc))
            pp = tree_unflatten(p, leaves)
            y = L.cross_attention_fwd(pp, cfg, xx,
                                      L.cross_attention_kv(pp, cfg, ee))
            g = torch.autograd.grad((y * cot.to(dtype)).sum(),
                                    leaves + [xx, ee])
            return [y.detach()] + list(g)

        out[f"S {S}"] = {n: _rel(lo, hi) for n, lo, hi in zip(
            names, run(torch.float32), run(torch.float64))}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="what", required=True)
    s = sub.add_parser("ssd")
    s.add_argument("--seq", type=int, nargs="+", default=[2048, 4097])
    s.add_argument("--heads", type=int, default=24)
    s.add_argument("--head-dim", type=int, default=64)
    s.add_argument("--d-state", type=int, default=128)
    s.add_argument("--chunk", type=int, default=256)
    m = sub.add_parser("moe")
    m.add_argument("--experts", type=int, default=4)
    m.add_argument("--std-experts", type=int, default=8)
    m.add_argument("--tokens", type=int, default=128)
    ml = sub.add_parser("mla")
    ml.add_argument("--seq", type=int, nargs="+", default=[512, 1025])
    ml.add_argument("--device", default="cpu")
    c = sub.add_parser("cross")
    c.add_argument("--seq", type=int, nargs="+", default=[512])
    c.add_argument("--gate", type=float, default=0.5)
    c.add_argument("--device", default="cpu")
    a = p.parse_args(argv)
    out = {"ssd": ssd, "moe": moe, "mla": mla, "cross": cross}[a.what](a)
    print(json.dumps({a.what: out, "rel_err": "f32 vs f64, of the largest "
                      "entry"}))
    return out


if __name__ == "__main__":
    main()
