"""Synthetic token pipeline for the LM substrate (port of
``repro.data.tokens``, a numpy copy of it).

A deterministic, seedable, infinite stream of (tokens, targets) batches with
host-side double buffering (prefetch): the shape of a real data pipeline
without the storage. Token statistics follow a Zipfian distribution so that
loss curves are not degenerate. The same seed gives the same int32 batches,
bit for bit, as the JAX package; the model casts them on entry.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


def zipf_logits(vocab_size: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / ranks ** alpha
    p /= p.sum()
    return np.log(p).astype(np.float32)


class SyntheticTokens:
    """Infinite stream of LM batches: tokens (B, S) int32, targets shifted."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, alpha: float = 1.1):
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self._rng = np.random.default_rng(seed)
        # sampling from a big zipf via inverse-cdf on a table
        p = np.exp(zipf_logits(self.vocab_size, alpha), dtype=np.float64)
        p /= p.sum()
        self._cdf = np.cumsum(p)

    def _sample(self, n: int) -> np.ndarray:
        u = self._rng.random(n)
        return np.searchsorted(self._cdf, u).astype(np.int32)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        flat = self._sample(self.batch_size * (self.seq_len + 1))
        arr = flat.reshape(self.batch_size, self.seq_len + 1)
        # clip to vocab range (searchsorted can hit vocab_size at u ~ 1.0)
        arr = np.minimum(arr, self.vocab_size - 1)
        return arr[:, :-1], arr[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()


class Prefetcher:
    """Host-side double-buffered prefetch of an iterator (daemon thread)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
