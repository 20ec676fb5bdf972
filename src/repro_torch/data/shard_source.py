"""Lazy per-client shard synthesis for streaming populations.

The eager ``build_scenario`` path draws one pooled dataset and splits it
globally — fine at M≈2048, impossible at M=1M.  A :class:`ShardSource` is
the streaming replacement: ``shard(cid)`` synthesizes client ``cid``'s data
on demand as a **pure function of (seed, cid)**, so the same client yields
bit-identical bytes on every call (paging a shard out of the device store
and back in later reproduces it exactly), and a lazily streamed population
equals its own eager materialization array-for-array.

Metadata — per-client class counts, shard sizes, dominant class — comes
from vectorized keyed hashing (`repro_torch.utils.seedhash`), so population and
per-edge class histograms are computed in O(M) numpy chunks without
materializing any data.  Assignment, wireless cost, and the accountant all
run off these analytic histograms.

Sources:
  * :class:`HealthShardSource` — ECG/EEG-like 1-D signals (the paper's
    datasets), per-client non-IID via a hash-drawn dominant class.
  * :class:`TokenShardSource`  — topic-skewed LM token shards for the
    sequence programs.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.data.lm_stream import TokenStream
from repro_torch.data.synthetic_health import Dataset, make_dataset
from repro_torch.utils.seedhash import keyed_hash, keyed_randint

# hash stream tags: distinct draws per client must live on distinct streams
_S_COUNTS = 0x5EED_0001  # per-(client, class) base count
_S_DOM = 0x5EED_0002  # per-client dominant class
_S_DATA = 0x5EED_0003  # shard-content RNG key component

_CHUNK = 1 << 16


class ShardSource:
    """Contract for lazy populations.

    Subclasses provide ``n_clients``, ``n_classes``, ``feat_shape`` (per-
    sample feature shape), ``feat_dtype``, and implement
    ``class_counts_block(lo, hi)`` (analytic, vectorized) and
    ``shard(cid)`` (pure in ``(seed, cid)``).  Everything else — sizes,
    dominant classes, population/edge histograms — derives from those.
    """

    seed: int
    n_clients: int
    n_classes: int
    feat_shape: Tuple[int, ...]
    feat_dtype: np.dtype

    def class_counts_block(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError

    def shard(self, cid: int) -> Dataset:
        raise NotImplementedError

    # -- derived, all chunked so 1M clients never allocates (M, K) floats ----
    def class_counts_for(self, cid: int) -> np.ndarray:
        return self.class_counts_block(cid, cid + 1)[0]

    @property
    def sizes(self) -> np.ndarray:
        """(M,) int32 shard sizes; computed once, cached."""
        cached = getattr(self, "_sizes", None)
        if cached is None:
            out = np.empty(self.n_clients, np.int32)
            for lo in range(0, self.n_clients, _CHUNK):
                hi = min(lo + _CHUNK, self.n_clients)
                out[lo:hi] = self.class_counts_block(lo, hi).sum(axis=1)
            self._sizes = cached = out
        return cached

    def population_histogram(self) -> np.ndarray:
        """(K,) int64 total samples per class across the population."""
        out = np.zeros(self.n_classes, np.int64)
        for lo in range(0, self.n_clients, _CHUNK):
            hi = min(lo + _CHUNK, self.n_clients)
            out += self.class_counts_block(lo, hi).sum(axis=0)
        return out

    def edge_histograms(self, edge_of: np.ndarray, n_edges: int) -> np.ndarray:
        """(N, K) int64 per-edge class histograms for an SCA assignment."""
        edge_of = np.asarray(edge_of)
        out = np.zeros((n_edges, self.n_classes), np.int64)
        for lo in range(0, self.n_clients, _CHUNK):
            hi = min(lo + _CHUNK, self.n_clients)
            np.add.at(out, edge_of[lo:hi], self.class_counts_block(lo, hi))
        return out

    def materialize(self, cids: Sequence[int] | None = None) -> List[Dataset]:
        """Eagerly synthesize shards (tests / small-M parity runs only)."""
        ids = range(self.n_clients) if cids is None else cids
        return [self.shard(int(c)) for c in ids]

    def iter_shards(self) -> Iterator[Dataset]:
        for c in range(self.n_clients):
            yield self.shard(c)

    def __len__(self) -> int:
        return self.n_clients


class HealthShardSource(ShardSource):
    """Streaming ECG/EEG population with hash-derived non-IID class counts.

    Each client's counts: a base count per class hashed into
    ``[min_per_class, max_per_class]``, plus ``dom_boost`` extra samples of a
    hash-drawn dominant class — the same dominant-class imbalance shape the
    eager builder uses (paper Tables 2–3), but analytically recoverable per
    client without an RNG stream.  ``shard(cid)`` then synthesizes the
    actual signals with ``default_rng((seed, _S_DATA, cid))``, so contents
    are pure in ``(seed, cid)``.
    """

    def __init__(
        self,
        seed: int,
        n_clients: int,
        *,
        n_classes: int = 5,
        length: int = 187,
        channels: int = 1,
        min_per_class: int = 0,
        max_per_class: int = 2,
        dom_boost: int = 8,
    ):
        if dom_boost < 1:
            raise ValueError("dom_boost must be >= 1 so every shard is non-empty")
        self.seed = int(seed)
        self.n_clients = int(n_clients)
        self.n_classes = int(n_classes)
        self.length = int(length)
        self.channels = int(channels)
        self.min_per_class = int(min_per_class)
        self.max_per_class = int(max_per_class)
        self.dom_boost = int(dom_boost)
        self.feat_shape = (self.length, self.channels)
        self.feat_dtype = np.dtype(np.float32)

    def dominant_block(self, lo: int, hi: int) -> np.ndarray:
        """(hi-lo,) int64 dominant class per client."""
        return keyed_randint(self.seed, _S_DOM, np.arange(lo, hi), self.n_classes)

    def class_counts_block(self, lo: int, hi: int) -> np.ndarray:
        cids = np.arange(lo, hi, dtype=np.int64)
        k = self.n_classes
        # one hash lane per (client, class): index = cid * K + class
        lanes = cids[:, None] * k + np.arange(k)[None, :]
        span = self.max_per_class - self.min_per_class + 1
        counts = (
            keyed_hash(self.seed, _S_COUNTS, lanes.ravel()).reshape(len(cids), k)
            % np.uint64(span)
        ).astype(np.int64) + self.min_per_class
        counts[np.arange(len(cids)), self.dominant_block(lo, hi)] += self.dom_boost
        return counts

    def shard(self, cid: int) -> Dataset:
        counts = self.class_counts_for(int(cid))
        rng = np.random.default_rng((self.seed, _S_DATA, int(cid)))
        return make_dataset(rng, counts, length=self.length, channels=self.channels)


class TokenShardSource(ShardSource):
    """Streaming LM population: topic-skewed token shards.

    Per-client counts follow the same hash scheme as the health source
    (classes = topics); ``shard(cid)`` materializes sequences from per-topic
    ``TokenStream`` generators keyed by ``(seed, cid, topic)`` so contents
    stay pure in ``(seed, cid)``.  Features are int32 token rows shaped
    ``(seq_len,)`` — the sequence programs treat them like any other shard.
    """

    def __init__(
        self,
        seed: int,
        n_clients: int,
        *,
        n_topics: int = 4,
        vocab_size: int = 128,
        seq_len: int = 32,
        min_per_topic: int = 0,
        max_per_topic: int = 2,
        dom_boost: int = 6,
    ):
        if dom_boost < 1:
            raise ValueError("dom_boost must be >= 1 so every shard is non-empty")
        self.seed = int(seed)
        self.n_clients = int(n_clients)
        self.n_classes = int(n_topics)
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.min_per_topic = int(min_per_topic)
        self.max_per_topic = int(max_per_topic)
        self.dom_boost = int(dom_boost)
        self.feat_shape = (self.seq_len,)
        self.feat_dtype = np.dtype(np.int32)

    def dominant_block(self, lo: int, hi: int) -> np.ndarray:
        return keyed_randint(self.seed, _S_DOM, np.arange(lo, hi), self.n_classes)

    def class_counts_block(self, lo: int, hi: int) -> np.ndarray:
        cids = np.arange(lo, hi, dtype=np.int64)
        k = self.n_classes
        lanes = cids[:, None] * k + np.arange(k)[None, :]
        span = self.max_per_topic - self.min_per_topic + 1
        counts = (
            keyed_hash(self.seed, _S_COUNTS, lanes.ravel()).reshape(len(cids), k)
            % np.uint64(span)
        ).astype(np.int64) + self.min_per_topic
        counts[np.arange(len(cids)), self.dominant_block(lo, hi)] += self.dom_boost
        return counts

    def shard(self, cid: int) -> Dataset:
        cid = int(cid)
        counts = self.class_counts_for(cid)
        xs, ys = [], []
        for t in range(self.n_classes):
            c = int(counts[t])
            if c == 0:
                continue
            key = int(keyed_hash(self.seed, _S_DATA, np.asarray([cid]))[0] >> np.uint64(1))
            stream = TokenStream(self.vocab_size, seed=key, topic=t)
            xs.append(stream.batch(c, self.seq_len).astype(np.int32))
            ys.append(np.full(c, t, np.int32))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = np.random.default_rng((self.seed, _S_DATA, cid)).permutation(len(y))
        return Dataset(x[perm], y[perm], self.n_classes)
