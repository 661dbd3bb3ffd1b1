"""The Mamba2 decoder ([arXiv:2405.21060]): per layer pre-norm, in_proj
to [z, x, B, C, dt], the depthwise causal conv and SiLU over [x, B, C],
dt = softplus(dt + dt_bias), A = -exp(A_log), the SSD scan by the
paper's chunked "minimal SSD" algorithm (one group: B and C shared by
the heads), the D skip, y * silu(z) through the gated RMSNorm,
out_proj, residual; then the final RMSNorm and the tied head.

``params_spec`` names every weight with its shape, stored dtype and
initial distribution, stacked over the layers on a leading axis."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from lgcref.common import einsum_of, f32_mm, rmsnorm

_MIXER = ("norm/scale", "in_proj/w", "conv_w", "conv_b", "A_log",
          "dt_bias", "D", "out_norm/scale", "out_proj/w")


def _dims(cfg):
    D = cfg["hidden_size"]
    di = cfg["expand"] * D
    N, P = cfg["state_size"], cfg["head_dim"]
    return D, di, N, P, di // P


def params_spec(cfg: Dict):
    """[(path, shape, dtype, init)]: the SSM's per-head A_log, dt_bias
    and D in float32, as the published model keeps them.  dt_bias is
    softplus^-1 of dt ~ logU[1e-3, 1e-1] and A ~ U[1, 16], the published
    initialisation."""
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    D, di, N, P, H = _dims(cfg)
    dt = cfg["torch_dtype"]
    m = "blocks/p0/mixer/"
    spec = [
        ("embed/w", (V, D), dt, ("normal", 0.02)),
        ("final_norm/scale", (D,), dt, ("ones",)),
        (m + "norm/scale", (L, D), dt, ("ones",)),
        (m + "in_proj/w", (L, D, 2 * di + 2 * N + H), dt,
         ("normal", D ** -0.5)),
        (m + "conv_w", (L, cfg["conv_kernel"], di + 2 * N), dt,
         ("normal", 0.1)),
        (m + "conv_b", (L, di + 2 * N), dt, ("zeros",)),
        (m + "A_log", (L, H), "float32", ("log_of_uniform", 1.0, 16.0)),
        (m + "dt_bias", (L, H), "float32",
         ("inv_softplus_log_uniform", 1e-3, 1e-1)),
        (m + "D", (L, H), "float32", ("ones",)),
        (m + "out_norm/scale", (L, di), dt, ("ones",)),
        (m + "out_proj/w", (L, di, D), dt, ("normal", di ** -0.5)),
    ]
    if not cfg["tie_word_embeddings"]:
        spec.append(("lm_head/w", (D, V), dt, ("normal", D ** -0.5)))
    return spec


def _segsum(x):
    """x (..., T) -> (..., T, T): sum of x[j+1..i] at [i, j] for i >= j,
    -inf above the diagonal."""
    T = x.shape[-1]
    xx = x[..., None].expand(*x.shape, T)                  # [.., i, j] = x_i
    low = torch.ones((T, T), dtype=torch.bool, device=x.device).tril(-1)
    xx = xx.masked_fill(~low, 0.0)
    out = torch.cumsum(xx, dim=-2)
    keep = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk: int, ein=torch.einsum):
    """y_t = sum_{s<=t} (C_t . B_s) exp(sum_{r=s+1..t} dt_r A) dt_s x_s
    by the paper's chunked algorithm.  x (b, S, H, P); dt (b, S, H); A
    (H,); Bm, Cm (b, S, N).  S a multiple of ``chunk``."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    c, l = S // chunk, chunk
    X = (x * dt[..., None]).view(b, c, l, H, P)
    Ad = (dt * A).view(b, c, l, H).permute(0, 3, 1, 2)      # (b, H, c, l)
    Bc, Cc = Bm.view(b, c, l, N), Cm.view(b, c, l, N)
    A_cum = torch.cumsum(Ad, dim=-1)
    Lm = torch.exp(_segsum(Ad))                              # (b, H, c, l, l)
    Y_diag = ein("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, Lm, X)
    decay = torch.exp(A_cum[..., -1:] - A_cum)               # (b, H, c, l)
    states = ein("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = ein("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    Y_off = ein("bcln,bchpn,bhcl->bclhp", Cc, states, torch.exp(A_cum))
    return (Y_diag + Y_off).reshape(b, S, H, P)


def _mixer(cfg, mm, x, wn, w_in, conv_w, conv_b, A_log, dt_bias, Dskip,
           w_onorm, w_out):
    b, S, _ = x.shape
    _, di, N, P, H = _dims(cfg)
    eps = cfg["rms_norm_eps"]
    h = rmsnorm(x, wn, eps)
    z, xBC, dt = torch.split(mm(h, w_in), [di, di + 2 * N, H], dim=-1)
    K = conv_w.shape[0]
    xBC = F.conv1d(F.pad(xBC.transpose(1, 2), (K - 1, 0)),
                   conv_w.t()[:, None, :], bias=conv_b,
                   groups=xBC.shape[-1]).transpose(1, 2)
    xs, Bm, Cm = torch.split(F.silu(xBC), [di, N, N], dim=-1)
    dt = F.softplus(dt + dt_bias, threshold=1e4)
    A = -torch.exp(A_log)
    xh = xs.reshape(b, S, H, P)
    ein = torch.einsum if mm is f32_mm else einsum_of(mm)
    y = ssd(xh, dt, A, Bm, Cm, cfg["chunk_size"], ein) \
        + xh * Dskip[:, None]
    y = y.reshape(b, S, di) * F.silu(z)
    return x + mm(rmsnorm(y, w_onorm, eps), w_out)


def layers(cfg: Dict, W: Dict[str, torch.Tensor], i: int):
    """Layer i's [(function, weights)]."""
    return [(_mixer, [W["blocks/p0/mixer/" + k][i] for k in _MIXER])]
