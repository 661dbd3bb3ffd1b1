"""Deterministic synthetic token stream (numpy, seeded per step).

Counterpart of ``repro.data.pipeline.synthetic_token_batches``: the same
first-order Markov chain with a skewed stationary distribution, the same
numpy generators, so the port and the reference see the same tokens bit
for bit.  Batches are host numpy; the trainer moves them to its device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synthetic_token_batches(vocab_size: int, batch: int, seq_len: int,
                            seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-chain token stream yielding {"tokens", "labels"}."""
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
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        step += 1
