"""Deterministic data streams (numpy, seeded per step).

Counterparts of ``repro.data.pipeline.synthetic_token_batches`` (the same
first-order Markov chain with a skewed stationary distribution),
``synthetic_image_batches`` (class templates plus noise) and
``text_file_token_batches`` (byte-level windows of a real file), with
the same numpy generators, so the port and the reference see the same
tokens and images bit for bit.  Batches are host numpy; the caller moves them to
its device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synthetic_token_batches(vocab_size: int, batch: int, seq_len: int,
                            seed: int = 0, encoder_tokens: int = 0,
                            encoder_dim: int = 0,
                            ) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-chain token stream yielding {"tokens", "labels"} and, when
    ``encoder_tokens`` > 0, "encoder_embeds" (batch, encoder_tokens,
    encoder_dim) f32 ~ N(0, 1): the stub of a vision frontend, drawn from
    the step's generator after the tokens, as the reference draws it."""
    base = np.random.default_rng(seed)
    # sparse transition structure: each token can go to 8 successors
    succ = base.integers(0, vocab_size, size=(vocab_size, 8))
    logits = base.normal(size=(vocab_size, 8)).astype(np.float64)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    step = 0
    while True:
        r = _rng(seed, step)
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = r.integers(0, vocab_size, size=batch)
        unif = r.random((batch, seq_len))
        for t in range(seq_len):
            cur = toks[:, t]
            cdf = probs[cur].cumsum(-1)
            choice = (unif[:, t : t + 1] < cdf).argmax(-1)
            toks[:, t + 1] = succ[cur, choice]
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if encoder_tokens:
            out["encoder_embeds"] = r.normal(
                size=(batch, encoder_tokens, encoder_dim)).astype(np.float32)
        yield out
        step += 1


def synthetic_image_batches(num_classes: int, batch: int, image_size: int,
                            channels: int = 3, seed: int = 0,
                            ) -> Iterator[Dict[str, np.ndarray]]:
    """Class-conditional Gaussian-blob images, NHWC f32, with int32
    labels: each class has a fixed random template; samples are template
    + noise, learnable by ConvNet5 within a few hundred steps."""
    base = np.random.default_rng(seed)
    templates = base.normal(size=(num_classes, image_size, image_size,
                                  channels)).astype(np.float32)
    step = 0
    while True:
        r = _rng(seed, step)
        labels = r.integers(0, num_classes, size=batch).astype(np.int32)
        noise = r.normal(scale=1.0,
                         size=(batch, image_size, image_size,
                               channels)).astype(np.float32)
        images = templates[labels] + noise
        yield {"images": images, "labels": labels}
        step += 1


def text_file_token_batches(path: str, batch: int, seq_len: int,
                            seed: int = 0,
                            ) -> Iterator[Dict[str, np.ndarray]]:
    """Byte-level LM batches from a real text file (vocab 256): per step,
    ``batch`` windows of ``seq_len + 1`` bytes at starts drawn by the
    step's generator, as the reference draws them, yielding int32
    {"tokens": (batch, seq_len), "labels": the next bytes}.  A file of
    ``seq_len + 1`` bytes or fewer is refused here, at the call."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8).astype(np.int32)
    if len(data) <= seq_len + 1:
        raise ValueError(f"file too small: {path} holds {len(data)} bytes, "
                         f"a window needs more than {seq_len + 1}")
    return _text_windows(data, batch, seq_len, seed)


def _text_windows(data: np.ndarray, batch: int, seq_len: int, seed: int):
    step = 0
    while True:
        r = _rng(seed, step)
        starts = r.integers(0, len(data) - seq_len - 1, size=batch)
        toks = np.stack([data[s:s + seq_len + 1] for s in starts])
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        step += 1
