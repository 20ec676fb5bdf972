"""Synthetic LM token stream for big-arch training/examples.

Markov-chain token generator with per-shard class skew: each federated shard
draws from a different topic (transition matrix), mirroring the paper's
non-IID class imbalance at the LM level.  Deterministic per (seed, shard).
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, topic: int = 0, order_vocab: int = 128):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed * 1000003 + topic)
        self.topic = topic
        # cheap markov structure over a reduced alphabet mapped into the vocab
        self.k = min(order_vocab, vocab_size)
        base = self.rng.random((self.k, self.k)) ** 3
        # topic-specific preferred successor pattern
        shift = np.roll(np.eye(self.k), topic + 1, axis=1) * 5.0
        self.trans = base + shift
        self.trans /= self.trans.sum(1, keepdims=True)
        self.map = self.rng.integers(0, vocab_size, self.k)

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch_size, seq_len), np.int32)
        state = self.rng.integers(0, self.k, batch_size)
        for t in range(seq_len):
            out[:, t] = self.map[state]
            u = self.rng.random((batch_size, 1))
            state = (self.trans[state].cumsum(1) > u).argmax(1)
        return out

    def train_batch(self, batch_size: int, seq_len: int) -> dict:
        toks = self.batch(batch_size, seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
