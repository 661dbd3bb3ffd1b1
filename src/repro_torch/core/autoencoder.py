"""The LGC gradient-compression autoencoders (paper Section IV, Tables
I/II) with both decode heads; counterpart of ``repro.core.autoencoder``.

  * RAR (aggregation):  g_rec = D_c(mean_k E_c(g_k))       (eq. 9-10)
  * PS  (decoupling):   g_rec_k = D_c^k(g_c, g_I_k)        (eq. 4): K
    decoders stacked on a leading axis, as the reference's
    ``jax.vmap(one_decoder)`` stacks them, each taking its node's
    innovation vector as an extra channel of the final 1x1 conv.

Layouts are the reference's: activations (B, L, C) (NWC), conv weights
(k, C_in, C_out) (WIO).  Two of lax's conventions need writing out in
PyTorch:

* ``"SAME"`` pads a stride-2 convolution asymmetrically, lo = total // 2;
* ``lax.conv_transpose(..., "SAME")`` (``transpose_kernel=False``) is
  "insert stride-1 zeros between the inputs, pad (2, 1) for k=3, s=2 or
  (1, 1) for k=3, s=1, then cross-correlate with the UNflipped kernel" —
  not ``F.conv_transpose1d`` with the same weights.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import node_mean

# (filters, kernel, stride) per Table I
ENCODER_SPEC = ((64, 3, 2), (128, 3, 2), (256, 3, 2), (64, 3, 2), (4, 1, 1))
# (filters, kernel, stride) per Table II (deconv1 stride 1, see reference)
DECODER_SPEC = ((4, 3, 1), (32, 3, 2), (64, 3, 2), (128, 3, 2), (32, 3, 2))

LEAKY_SLOPE = 0.01
ENC_FACTOR = 16          # total length downsampling of the encoder
BOTTLENECK_CH = 4


def _conv_init(gen, k, c_in, c_out, device):
    w = torch.randn((k, c_in, c_out), generator=gen, device=device,
                    dtype=torch.float32)
    return w * math.sqrt(2.0 / (k * c_in))


def init_lgc_autoencoder(gen: torch.Generator, device="cpu",
                         num_decoders: int = 1,
                         ps_innovation: bool = False) -> Dict:
    """AE params: {"encoder": [{"w", "b"}] * 5, "decoder": [{"w", "b"}] *
    6}.  ``num_decoders`` = K for the PS pattern (one decoder per node):
    each decoder leaf then carries a leading K axis.  ``ps_innovation``
    adds the innovation channel to each decoder's final conv."""
    def layer(k, c_in, c_out, lead=()):
        w = torch.stack([_conv_init(gen, k, c_in, c_out, device)
                         for _ in range(lead[0])]) if lead \
            else _conv_init(gen, k, c_in, c_out, device)
        return {"w": w, "b": torch.zeros(lead + (c_out,), device=device)}
    enc, c_in = [], 1
    for c_out, k, _s in ENCODER_SPEC:
        enc.append(layer(k, c_in, c_out))
        c_in = c_out
    lead = (num_decoders,) if num_decoders > 1 else ()
    dec, ci = [], BOTTLENECK_CH
    for c_out, k, _s in DECODER_SPEC:
        dec.append(layer(k, ci, c_out, lead))
        ci = c_out
    dec.append(layer(1, ci + (1 if ps_innovation else 0), 1, lead))
    return {"encoder": enc, "decoder": dec}


def _conv1d(p, x, stride):
    """x: (B, L, C) -> (B, ceil(L/stride), C_out); lax SAME padding."""
    k = p["w"].shape[0]
    L = x.shape[1]
    L_out = -(-L // stride)
    total = max((L_out - 1) * stride + k - L, 0)
    xp = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(xp, p["w"].permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + p["b"]


def _deconv1d(p, x, stride):
    """lax.conv_transpose(x, w, (stride,), "SAME"), unflipped kernel."""
    k = p["w"].shape[0]
    B, L, C = x.shape
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else int(np.ceil(pad_len / 2))
    xt = x.transpose(1, 2)
    if stride > 1:
        xd = x.new_zeros((B, C, (L - 1) * stride + 1))
        xd[..., ::stride] = xt
        xt = xd
    xp = F.pad(xt, (pad_a, pad_len - pad_a))
    y = F.conv1d(xp, p["w"].permute(2, 1, 0))
    return y.transpose(1, 2) + p["b"]


def lgc_encode(ae_params, g: torch.Tensor) -> torch.Tensor:
    """g: (L,) or (B, L) -> compressed rep (B, L/16, 4).  L % 16 == 0."""
    if g.dim() == 1:
        g = g[None]
    x = g[..., None].float()
    for p, (_c, _k, s) in zip(ae_params["encoder"], ENCODER_SPEC):
        x = F.leaky_relu(_conv1d(p, x, s), LEAKY_SLOPE)
    return x


def _decode_stack(dec_params, z, innovation=None):
    x = z
    for i, (_c, _k, s) in enumerate(DECODER_SPEC):
        x = F.leaky_relu(_deconv1d(dec_params[i], x, s), LEAKY_SLOPE)
    if innovation is not None:                            # PS: extra channel
        x = torch.cat([x, innovation[..., None]], dim=-1)
    return _conv1d(dec_params[-1], x, 1)[..., 0]          # (B, L)


def lgc_decode_rar(ae_params, z_avg: torch.Tensor) -> torch.Tensor:
    """Aggregation decoder (eq. 10): z_avg (B, L/16, 4) -> (B, L)."""
    return _decode_stack(ae_params["decoder"], z_avg)


def lgc_decode_ps(ae_params, z_common: torch.Tensor,
                  innovations: torch.Tensor) -> torch.Tensor:
    """Decoupling decoders (eq. 4): K per-node decoders (stacked on the
    leading axis of every decoder leaf) share the common representation
    z_common (L/16, 4); decoder k takes node k's innovation vector
    (innovations: (K, L)).  Returns (K, L)."""
    dec = ae_params["decoder"]
    return torch.stack([
        _decode_stack([{n: p[n][k] for n in p} for p in dec],
                      z_common[None], innovations[k][None])[0]
        for k in range(innovations.shape[0])])


def ae_loss_rar(ae_params, g_nodes: torch.Tensor) -> torch.Tensor:
    """eq. (11), per-element mean: ||D(mean_k E(g_k)) - mean_k g_k||^2,
    the means over nodes as the reference computes them under jit."""
    z = lgc_encode(ae_params, g_nodes)                    # (K, L/16, 4)
    g_rec = lgc_decode_rar(ae_params, node_mean(z)[None])[0]
    return torch.mean((g_rec - node_mean(g_nodes)) ** 2)


def ae_loss_ps(ae_params, g_nodes: torch.Tensor, innovations: torch.Tensor,
               common_idx: int, lambda_rec: float = 1.0,
               lambda_sim: float = 0.5) -> Tuple[torch.Tensor, Dict]:
    """eq. (5)-(7): node ``common_idx``'s encoding is the common
    representation; decoder k reconstructs node k's gradient from it and
    node k's innovation.  The similarity term is the per-element mean of
    ||E(g_k) - E(g_m)||^2 summed over the K x K pairs, over max(K(K-1),
    1).  g_nodes, innovations: (K, L).  Returns (loss, {"l_rec",
    "l_sim"})."""
    K = g_nodes.shape[0]
    z = lgc_encode(ae_params, g_nodes)                    # (K, L/16, 4)
    diff = z[:, None] - z[None, :]                        # (K, K, L/16, 4)
    l_sim = torch.sum(torch.mean(diff ** 2, dim=(2, 3))) / max(K * (K - 1),
                                                               1)
    g_rec = lgc_decode_ps(ae_params, z[common_idx], innovations)
    l_rec = torch.mean((g_nodes - g_rec) ** 2)            # eq. (6)
    loss = lambda_rec * l_rec + lambda_sim * l_sim        # eq. (7)
    return loss, {"l_rec": l_rec, "l_sim": l_sim}


def compressed_length(mu: int) -> int:
    """Number of floats in the transmitted representation for input len mu."""
    assert mu % ENC_FACTOR == 0
    return mu // ENC_FACTOR * BOTTLENECK_CH
