"""The LGC autoencoder of the ring-allreduce pattern (paper Section IV,
Tables I and II): g_rec = D(mean_k E(g_k)) (eq. 9-10), trained on
||D(mean_k E(g_k)) - mean_k g_k||^2 (eq. 11).  Activations (B, L, C),
conv weights (k, C_in, C_out), as the paper's TensorFlow layers hold
them, with their "SAME" conventions written out:

* a stride-2 convolution pads asymmetrically, lo = total // 2;
* the transposed convolution inserts stride - 1 zeros between the
  inputs, pads (2, 1) for k = 3, s = 2 or (1, 1) for k = 3, s = 1, and
  cross-correlates with the kernel as stored (not flipped).

A frozen copy of that arithmetic, kept with the benchmark so that the
reference does not read the program's."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

# (filters, kernel, stride) per Table I
ENCODER_SPEC = ((64, 3, 2), (128, 3, 2), (256, 3, 2), (64, 3, 2), (4, 1, 1))
# (filters, kernel, stride) per Table II, then a 1x1 conv to one channel
DECODER_SPEC = ((4, 3, 1), (32, 3, 2), (64, 3, 2), (128, 3, 2), (32, 3, 2))
LEAKY_SLOPE = 0.01
ALIGN = 16                      # the encoder downsamples by 16


def spec():
    """[(path, kernel, c_in, c_out)] of the AE's conv layers, encoder
    then decoder, in the tree the program holds them in."""
    out, c_in = [], 1
    for i, (c_out, k, _s) in enumerate(ENCODER_SPEC):
        out.append((f"encoder/{i}", k, c_in, c_out))
        c_in = c_out
    c_in = ENCODER_SPEC[-1][0]
    for i, (c_out, k, _s) in enumerate(DECODER_SPEC):
        out.append((f"decoder/{i}", k, c_in, c_out))
        c_in = c_out
    out.append((f"decoder/{len(DECODER_SPEC)}", 1, c_in, 1))
    return out


def init(gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """{"<part>/<i>/w", "<part>/<i>/b"}: He-normal kernels, zero biases,
    float32, drawn in ``spec`` order from ``gen``."""
    ae = {}
    for path, k, c_in, c_out in spec():
        ae[path + "/w"] = torch.randn((k, c_in, c_out), generator=gen,
                                      device=device) \
            * math.sqrt(2.0 / (k * c_in))
        ae[path + "/b"] = torch.zeros((c_out,), device=device)
    return ae


def _conv(w, b, x, stride):
    k, L = w.shape[0], x.shape[1]
    L_out = -(-L // stride)
    total = max((L_out - 1) * stride + k - L, 0)
    xp = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    return F.conv1d(xp, w.permute(2, 1, 0), stride=stride).transpose(1, 2) \
        + b


def _deconv(w, b, x, stride):
    k = w.shape[0]
    B, L, C = x.shape
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else math.ceil(pad_len / 2)
    xt = x.transpose(1, 2)
    if stride > 1:
        xd = x.new_zeros((B, C, (L - 1) * stride + 1))
        xd[..., ::stride] = xt
        xt = xd
    xp = F.pad(xt, (pad_a, pad_len - pad_a))
    return F.conv1d(xp, w.permute(2, 1, 0)).transpose(1, 2) + b


def encode(ae, g):
    """g (B, L) -> (B, L/16, 4)."""
    x = g[..., None]
    for i, (_c, _k, s) in enumerate(ENCODER_SPEC):
        x = F.leaky_relu(_conv(ae[f"encoder/{i}/w"], ae[f"encoder/{i}/b"],
                               x, s), LEAKY_SLOPE)
    return x


def decode(ae, z):
    """z (B, L/16, 4) -> (B, L)."""
    x = z
    for i, (_c, _k, s) in enumerate(DECODER_SPEC):
        x = F.leaky_relu(_deconv(ae[f"decoder/{i}/w"], ae[f"decoder/{i}/b"],
                                 x, s), LEAKY_SLOPE)
    n = len(DECODER_SPEC)
    return _conv(ae[f"decoder/{n}/w"], ae[f"decoder/{n}/b"], x, 1)[..., 0]


def loss(ae, g_nodes):
    """eq. (11) as a per-element mean; g_nodes (K, L)."""
    z = encode(ae, g_nodes).mean(0, keepdim=True)
    return torch.mean((decode(ae, z)[0] - g_nodes.mean(0)) ** 2)
