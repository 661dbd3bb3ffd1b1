"""The traffic's token batches: a first-order Markov chain over the
vocabulary, each token with 8 successors under a skewed distribution
(a copy of the program's ``data.pipeline.synthetic_token_batches``,
kept here so that the benchmark's inputs do not move with the program).
Batch b of a pool is the stream's step b; the pool's batches run
through the chain together, so a pool costs one pass over the sequence
length."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def pool(vocab_size: int, rows: int, seq_len: int, seed: int,
         n_batches: int) -> List[Dict[str, np.ndarray]]:
    """``n_batches`` batches of {"tokens", "labels"}: (rows, seq_len)
    int64 each, the labels the next tokens."""
    base = np.random.default_rng(seed)
    succ = base.integers(0, vocab_size, size=(vocab_size, 8))
    logits = base.normal(size=(vocab_size, 8)).astype(np.float64)
    cdf = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
           ).cumsum(-1)
    R = n_batches * rows
    toks = np.empty((R, seq_len + 1), np.int64)
    unif = np.empty((R, seq_len))
    for b in range(n_batches):
        r = np.random.default_rng(np.random.SeedSequence([seed, b]))
        sl = slice(b * rows, (b + 1) * rows)
        toks[sl, 0] = r.integers(0, vocab_size, size=rows)
        unif[sl] = r.random((rows, seq_len))
    for t in range(seq_len):
        cur = toks[:, t]
        choice = (unif[:, t:t + 1] < cdf[cur]).argmax(-1)
        toks[:, t + 1] = succ[cur, choice]
    return [{"tokens": toks[b * rows:(b + 1) * rows, :-1],
             "labels": toks[b * rows:(b + 1) * rows, 1:].copy()}
            for b in range(n_batches)]
