"""Vectorized keyed hashing for streaming populations.

A million-client population cannot afford one ``np.random.default_rng``
instance per client just to know *how much data everyone has*: the engines,
the assignment planner, and the accountant all need population-level class
histograms without materializing a single shard.  This module provides a
splitmix64-based keyed hash that maps ``(seed, stream, index)`` tuples to
uniform integers/floats **vectorized over index**, so per-client metadata
(class counts, dominant class, Pareto participation weights) is an O(M)
numpy expression instead of an O(M) python loop.

Shard *contents* still come from ``np.random.default_rng`` keyed per client
(`repro_torch.data.shard_source`) — the hash here only decides cheap integer
metadata, and both are pure functions of ``(seed, client)`` so a lazily
synthesized shard is bit-identical to its eager materialization.
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64
_GAMMA = _U64(0x9E3779B97F4A7C15)
_M1 = _U64(0xBF58476D1CE4E5B9)
_M2 = _U64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer, elementwise over a uint64 array."""
    z = np.asarray(x, dtype=_U64)
    with np.errstate(over="ignore"):
        z = (z + _GAMMA) & ~_U64(0)
        z = (z ^ (z >> _U64(30))) * _M1
        z = (z ^ (z >> _U64(27))) * _M2
        z = z ^ (z >> _U64(31))
    return z


def keyed_hash(seed: int, stream: int, idx: np.ndarray) -> np.ndarray:
    """uint64 hash of each element of ``idx`` under ``(seed, stream)``.

    Two mixing rounds so that consecutive indices (the common case: client
    ids 0..M-1) decorrelate; ``seed`` and ``stream`` land in different
    rounds so streams never alias across seeds.
    """
    idx = np.asarray(idx, dtype=_U64)
    with np.errstate(over="ignore"):
        h = splitmix64(idx ^ splitmix64(np.asarray(_U64(seed & 0xFFFFFFFFFFFFFFFF))))
        h = splitmix64(h + _U64(stream & 0xFFFFFFFFFFFFFFFF) * _GAMMA)
    return h


def keyed_uniform(seed: int, stream: int, idx: np.ndarray) -> np.ndarray:
    """float64 in [0, 1) per element of ``idx``, pure in (seed, stream, idx)."""
    return (keyed_hash(seed, stream, idx) >> _U64(11)).astype(np.float64) * (
        1.0 / float(1 << 53)
    )


def keyed_randint(seed: int, stream: int, idx: np.ndarray, n: int) -> np.ndarray:
    """int64 in [0, n) per element of ``idx`` (modulo reduction; fine for the
    small ``n`` — class counts, edge ids — this module serves)."""
    return (keyed_hash(seed, stream, idx) % _U64(n)).astype(np.int64)
