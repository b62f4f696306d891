"""Synthetic language-model token pipeline (numpy only; a copy of
``repro.data.lm``, so both packages see the same batches).

For the LM architectures there is no offline corpus; training runs use a
synthetic Zipf-distributed token stream with deterministic per-step
generation (a pure function of (seed, step)), which is enough to exercise
the full training path (the loss falls as the model learns the
marginal and bigram statistics). Tokens and labels are numpy int32, as
in the reference; the model's embedding gather wants ``torch.long``, so
callers convert where the batch reaches the device.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _zipf_probs(vocab: int, s: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-s)
    return (p / p.sum()).astype(np.float64)


def synthetic_lm_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    seed: int = 0,
    zipf_s: float = 1.1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens, labels) with a learnable markov-ish structure."""
    probs = _zipf_probs(min(vocab_size, 4096), zipf_s)
    support = len(probs)
    step = 0
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        base = rng.choice(support, size=(batch, seq_len + 1), p=probs)
        # inject bigram structure: with prob .5, next token = f(prev)
        follow = (base[:, :-1] * 7 + 3) % support
        coin = rng.random((batch, seq_len)) < 0.5
        seq = base.copy()
        seq[:, 1:] = np.where(coin, follow, base[:, 1:])
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        yield tokens, labels
        step += 1
