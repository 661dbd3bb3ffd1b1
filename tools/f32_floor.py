"""How far one f32 evaluation lies from an f64 one, for the chunked SSD
scan and for the MoE layer at their published widths: the output and
every gradient of sum(y * r) (+ the aux loss), each as the largest |f32
- f64| over the largest |f64|.  Two f32 evaluations that sum in another
order (the card against the CPU, the port against the reference) differ
by about as much, so this is the floor under any tolerance that compares
them.  Runs on the CPU.

    PYTHONPATH=src python tools/f32_floor.py ssd [--seq 2048 4097]
    PYTHONPATH=src python tools/f32_floor.py moe [--experts 4 --tokens 128]

ssd: mamba2-130m's scan (24 heads of 64, d_state 128, chunk 256), batch
1, from numpy seed 0: dt = softplus(N(0, 1)), A = -exp(U[0, log 16]) as
the reference draws its decay, x, B, C, D ~ N(0, 1).  moe: arctic-480b's
widths (d_model 7168, d_ff_expert 4864, the dense residual), ``--experts``
experts drawn with the std of ``--std-experts`` (the reference's
1/sqrt(E) scale; default 8, chip_smoke's moe phase), ``--tokens``
tokens; its router and norms compute in f32 in both runs, as the
layer's code says.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


def _rel(lo, hi) -> float:
    return float((lo.double() - hi).abs().max() / hi.abs().max())


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
    a = p.parse_args(argv)
    out = {"ssd": ssd, "moe": moe}[a.what](a)
    print(json.dumps({a.what: out, "rel_err": "f32 vs f64, of the largest "
                      "entry"}))
    return out


if __name__ == "__main__":
    main()
