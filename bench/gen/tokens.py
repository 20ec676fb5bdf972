"""Topic-skewed token batches: the benchmark's copy of the port's
``data/lm_stream.py::TokenStream``.

A Markov chain over a 128-token alphabet mapped into the vocabulary; each
topic has its own preferred-successor pattern, so edges fed different
topics hold differently distributed text (the LM counterpart of the
paper's class imbalance).  Deterministic per (seed, topic).  Nothing here
imports the program.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, topic: int = 0, order_vocab: int = 128):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed * 1000003 + topic)
        self.topic = topic
        self.k = min(order_vocab, vocab_size)
        base = self.rng.random((self.k, self.k)) ** 3
        shift = np.roll(np.eye(self.k), topic + 1, axis=1) * 5.0
        self.trans = base + shift
        self.trans /= self.trans.sum(1, keepdims=True)
        self.map = self.rng.integers(0, vocab_size, self.k)

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch_size, seq_len), np.int32)
        state = self.rng.integers(0, self.k, batch_size)
        cum = self.trans.cumsum(1)
        for t in range(seq_len):
            out[:, t] = self.map[state]
            u = self.rng.random((batch_size, 1))
            state = (cum[state] > u).argmax(1)
        return out


def edge_batches(seed: int, n_edges: int, steps: int, batch: int, seq: int, vocab: int) -> np.ndarray:
    """(steps, E, batch, seq + 1) int64 tokens: edge e's rows from the
    stream of topic e, every row its own draw."""
    out = np.empty((steps, n_edges, batch, seq + 1), np.int64)
    for e in range(n_edges):
        rows = TokenStream(vocab, seed=int(seed) % (1 << 40), topic=e).batch(steps * batch, seq + 1)
        out[:, e] = rows.reshape(steps, batch, seq + 1)
    return out
