"""Which clients train each round and on which samples, worked out again
from the seeds the program was given.

The streaming engine draws a round's cohort from its ``CohortSpec``'s
keyed side channel (a uniform sample by Floyd's algorithm) and each
member's batches from its own generator (one permutation per member and
local epoch, padded by resampling, members in ascending id); a member
runs ``ceil(n / batch)`` steps rounded up to a power of two (at most
``max_steps``).  These functions compute the same from the same seeds, in
plain numpy.
"""
from __future__ import annotations

import numpy as np

COHORT_TAG = 0xC0_4081
STEP_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def cohort(spec_seed: int, size: int, n_clients: int, cloud_round: int = 1, edge_round: int = 1) -> np.ndarray:
    """Sorted member ids of a uniform cohort over clients 0..M-1."""
    c = min(size, n_clients)
    if c == n_clients:
        return np.arange(n_clients, dtype=np.int64)
    rs = np.random.default_rng((spec_seed, COHORT_TAG, int(cloud_round), int(edge_round)))
    chosen = set()
    for j in range(n_clients - c, n_clients):
        t = int(rs.integers(0, j + 1))
        chosen.add(j if t in chosen else t)
    return np.sort(np.fromiter(chosen, np.int64, c))


def local_steps(n: np.ndarray, batch: int, max_steps: int = 128) -> np.ndarray:
    """Steps of one local epoch for shards of ``n`` samples (0 for none)."""
    n = np.asarray(n, np.int64)
    raw = np.clip((n + batch - 1) // batch, 1, max_steps)
    buckets = np.asarray(STEP_BUCKETS, np.int64)
    pos = np.minimum(np.searchsorted(buckets, raw, side="left"), len(buckets) - 1)
    return np.where(n > 0, buckets[pos], 0)


def batch_indices(rng: np.random.Generator, n: int, steps: int, batch: int) -> np.ndarray:
    """(steps, batch) in-shard indices of one local epoch."""
    idx = rng.permutation(n)
    need = steps * batch
    if need > n:
        idx = np.concatenate([idx, rng.integers(0, n, need - n)])
    return idx[:need].reshape(steps, batch)
