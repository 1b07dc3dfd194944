"""Deterministic synthetic data (no network access in this repo).

Copies of ``repro.data.synthetic``, NumPy only and equal to the
reference's arrays byte for byte:

* ``token_batch`` — a Markov-ish token stream with local structure so an
  LM has signal to learn, deterministic per ``(seed, step, shard_index)``;
* ``image_batch`` — class-template images plus noise (NHWC f32, int32
  labels), the paper's CNN experiments' stand-in for ImageNet.
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


def image_batch(n_classes: int, batch: int, img: int, *, seed: int, step: int,
                templates: np.ndarray | None = None):
    """Returns ({"images": (B,H,W,3) f32, "labels": (B,) i32}, templates)."""
    rng_t = np.random.default_rng(seed)
    if templates is None:
        templates = rng_t.normal(size=(n_classes, img, img, 3)).astype(
            np.float32)
    rng = np.random.default_rng(np.random.SeedSequence([seed + 1, step]))
    labels = rng.integers(0, n_classes, size=batch)
    noise = rng.normal(scale=1.5, size=(batch, img, img, 3)).astype(np.float32)
    images = templates[labels] + noise
    return {"images": images, "labels": labels.astype(np.int32)}, templates
