"""Data pipeline: synthetic LM corpora with deterministic generation and
host-side prefetch — the port of ``repro.train.data``, numpy as there, so
a seed gives the JAX package's numbers.

``MarkovLM`` builds a fixed random first-order Markov chain; its
per-token entropy is computable in closed form, so a training run has a
known CE floor.  ``batches`` yields (tokens, labels) with double-buffered
host prefetch (a daemon thread).
"""
from __future__ import annotations

import threading
from queue import Queue
from typing import Iterator, Tuple

import numpy as np


class MarkovLM:
    def __init__(self, vocab: int, seed: int = 0, concentration: float = 0.3):
        rng = np.random.default_rng(seed)
        probs = rng.dirichlet(np.full(vocab, concentration), size=vocab)
        self.vocab = vocab
        self.P = probs.astype(np.float64)

    def entropy(self) -> float:
        """Stationary per-token entropy (nats) — the CE floor."""
        evals, evecs = np.linalg.eig(self.P.T)
        i = int(np.argmin(np.abs(evals - 1.0)))
        pi = np.real(evecs[:, i])
        pi = np.abs(pi) / np.abs(pi).sum()
        row_h = -np.sum(self.P * np.log(np.maximum(self.P, 1e-12)), axis=1)
        return float(pi @ row_h)

    def sample(self, rng: np.random.Generator, batch: int, seq: int):
        out = np.empty((batch, seq + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            cdf = np.cumsum(self.P[out[:, t]], axis=1)
            u = rng.random((batch, 1))
            out[:, t + 1] = (u > cdf).sum(axis=1)
        return out


def batches(
    lm: MarkovLM, batch: int, seq: int, seed: int = 1, prefetch: int = 2
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens [b, s], labels [b, s]) with background prefetch."""
    q: Queue = Queue(maxsize=prefetch)

    def worker():
        rng = np.random.default_rng(seed)
        while True:
            chunk = lm.sample(rng, batch, seq)
            q.put((chunk[:, :-1], chunk[:, 1:]))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        yield q.get()
