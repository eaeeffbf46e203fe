"""Synthetic LM token pipeline for training examples / smoke tests — the
port's own copy of `repro.data.lm` (numpy only): the same arrays from the
same seed."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def synthetic_token_batches(vocab: int, batch: int, seq: int, *,
                            steps: int, seed: int = 0,
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Zipf-distributed token stream with a learnable bigram structure
    (each token biases the next), so loss visibly decreases in examples."""
    rng = np.random.default_rng(seed)
    shift = rng.integers(1, vocab, size=(min(vocab, 4096),))
    for _ in range(steps):
        base = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
        # 60% of positions follow the deterministic bigram map
        follow = rng.random((batch, seq)) < 0.6
        nxt = shift[base[:, :-1] % shift.shape[0]] % vocab
        base[:, 1:] = np.where(follow, nxt, base[:, 1:])
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        yield tokens, labels
