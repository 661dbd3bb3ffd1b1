"""ConvNet5, the paper's Section VI-E model: 5 conv layers, each followed
by batch-norm + ReLU, global-average-pool, linear classifier.
Counterpart of ``repro.models.convnet``.

The tree keeps the reference's layout, so the flat gradient and the
compressor's layout are the reference's: ``conv{i}`` = {"bn_bias",
"bn_scale", "w" (HWIO)}, ``fc`` = {"b", "w" (in, out)}; images are NHWC.
The forward permutes to PyTorch's NCHW / OIHW inside and nowhere else.

Two hazards of the translation, both handled here:
* ``padding="SAME"`` with stride 2 pads asymmetrically: total = max((out
  - 1)·s + k - in, 0), before = total // 2, after = the rest, so 32 -> 16
  pads (0, 1).  ``F.conv2d(padding=1)`` pads (1, 1) and shifts the
  result; the forward pads explicitly.
* BN normalises with the population variance (``jnp.var``), per batch
  (training mode, no running statistics), so each node normalises over
  its own shard: ``var(correction=0)``.

The model is f32, as the reference's is; on the card the caller turns
TF32 off (:func:`repro_torch.utils.disable_tf32`), since cuDNN's f32
convolutions default to it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.convnet5 import ConvNet5Config


def init_convnet5(gen: torch.Generator, cfg: ConvNet5Config,
                  device="cpu") -> Dict:
    """He-normal conv weights, BN scale 1 and bias 0, a 1/sqrt(fan_in)
    classifier; the reference's scales (its draws are jax.random's, so a
    test carries the reference's weights across with
    ``utils.convert.params_from_numpy``)."""
    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * scale

    params = {}
    c_in = cfg.in_channels
    for i, c_out in enumerate(cfg.channels):
        params[f"conv{i}"] = {
            "w": normal((3, 3, c_in, c_out), math.sqrt(2.0 / (9 * c_in))),
            "bn_scale": torch.ones(c_out, device=device),
            "bn_bias": torch.zeros(c_out, device=device),
        }
        c_in = c_out
    params["fc"] = {
        "w": normal((c_in, cfg.num_classes), math.sqrt(1.0 / c_in)),
        "b": torch.zeros(cfg.num_classes, device=device),
    }
    return params


def _same_pad(size: int, k: int, s: int):
    """XLA's SAME padding of one spatial axis: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def convnet5_forward(params, cfg: ConvNet5Config, images: torch.Tensor):
    """images: (B, H, W, C) f32 -> logits (B, num_classes).

    Batch-norm uses per-batch statistics (training mode), as the paper
    trains ConvNet5."""
    h = images.permute(0, 3, 1, 2)                        # NCHW
    for i, _ in enumerate(cfg.channels):
        p = params[f"conv{i}"]
        s = 2 if i % 2 else 1
        (top, bottom), (left, right) = (_same_pad(h.shape[2], 3, s),
                                        _same_pad(h.shape[3], 3, s))
        h = F.conv2d(F.pad(h, (left, right, top, bottom)),
                     p["w"].permute(3, 2, 0, 1), stride=s)
        var, mean = torch.var_mean(h, dim=(0, 2, 3), keepdim=True,
                                   correction=0)
        h = (h - mean) * torch.rsqrt(var + 1e-5)
        h = h * p["bn_scale"][:, None, None] + p["bn_bias"][:, None, None]
        h = torch.relu(h)
    h = h.mean(dim=(2, 3))                                # GAP
    return h @ params["fc"]["w"] + params["fc"]["b"]


def convnet5_loss(params, cfg: ConvNet5Config, batch):
    """batch: {"images": (B, H, W, C), "labels": (B,) int}.  Returns
    (loss, {"loss", "accuracy"})."""
    logits = convnet5_forward(params, cfg, batch["images"])
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}
