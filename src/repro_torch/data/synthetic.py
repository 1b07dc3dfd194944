"""Deterministic synthetic token data (no network access in this repo).

A copy of ``repro.data.synthetic.token_batch``: a Markov-ish stream with
local structure so an LM has signal to learn, deterministic per
``(seed, step, shard_index)``; NumPy only, equal to the reference's arrays.
"""
from __future__ import annotations

import numpy as np


def token_batch(vocab: int, batch: int, seq: int, *, seed: int, step: int,
                shard_index: int = 0, shard_count: int = 1):
    """Returns {"tokens", "targets"} int32 arrays of shape (batch, seq)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step,
                                                        shard_index]))
    b = batch // shard_count
    # next token = (prev * a + noise) % vocab
    a = 31
    x = rng.integers(0, vocab, size=(b, seq + 1))
    noise = rng.integers(0, max(2, vocab // 64), size=(b, seq))
    for t in range(1, seq + 1):
        x[:, t] = (x[:, t - 1] * a + noise[:, t - 1]) % vocab
    return {"tokens": x[:, :-1].astype(np.int32),
            "targets": x[:, 1:].astype(np.int32)}
