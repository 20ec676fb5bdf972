"""Non-IID partitioning of datasets across EUs + the paper's Table 2/3 presets.

The paper distributes data "randomly into the EUs, such that we maintain
non-IID data distribution between different EUs", with the *initial
edge-level* distributions fixed by Tables 2 and 3.  We reproduce that by:
  1. constructing per-edge class totals from the tables,
  2. splitting each edge's pool across its EUs with a per-EU dominant class,
  3. recording the resulting per-EU class_counts matrix (M, K) — the c_k^i
     inputs of the assignment problem.

Also provides a Dirichlet partitioner (the standard FL non-IID generator)
used by the extended experiments.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.data.synthetic_health import Dataset

# Table 2: Seizure — 3 edges x 3 classes
TABLE2_SEIZURE = np.array(
    [
        [1459, 25, 25],
        [25, 1160, 25],
        [25, 25, 1238],
    ],
    dtype=np.int64,
)

# Table 3: Heartbeat — 5 edges x 5 classes (x1000 instances)
TABLE3_HEARTBEAT = np.array(
    [
        [10, 10, 0, 0, 0],
        [0, 0, 10, 10, 0],
        [10, 0, 0, 0, 10],
        [0, 10, 10, 0, 0],
        [0, 0, 0, 10, 10],
    ],
    dtype=np.int64,
) * 1000


def eu_counts_from_edge_table(
    rng: np.random.Generator,
    edge_table: np.ndarray,
    eus_per_edge: List[int],
    *,
    scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split per-edge class totals over that edge's EUs.

    Returns (class_counts (M, K), initial_assignment (M,) edge index).
    Each EU receives a random share of each class present at its edge, so EUs
    are individually non-IID while edge-level sums match the table.
    """
    n_edges, k = edge_table.shape
    counts, init_edge = [], []
    for j in range(n_edges):
        m_j = eus_per_edge[j]
        # random fractions per EU per class (Dirichlet over EUs)
        frac = rng.dirichlet(np.ones(m_j) * 0.5, size=k).T  # (m_j, K)
        tot = np.maximum((edge_table[j] * scale).astype(np.int64), 0)
        cc = np.floor(frac * tot[None, :]).astype(np.int64)
        # fix rounding: give remainder to the first EU
        cc[0] += tot - cc.sum(axis=0)
        counts.append(cc)
        init_edge += [j] * m_j
    return np.concatenate(counts, 0), np.asarray(init_edge)


def dirichlet_partition(
    rng: np.random.Generator, labels: np.ndarray, n_eus: int, alpha: float = 0.3
) -> List[np.ndarray]:
    """Standard Dirichlet(alpha) label-skew partition; returns index lists."""
    k = labels.max() + 1
    idx_by_class = [np.nonzero(labels == c)[0] for c in range(k)]
    out = [[] for _ in range(n_eus)]
    for c in range(k):
        idx = rng.permutation(idx_by_class[c])
        props = rng.dirichlet(np.full(n_eus, alpha))
        splits = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, splits)):
            out[i].extend(part.tolist())
    return [np.asarray(sorted(o)) for o in out]


def split_dataset_by_counts(
    rng: np.random.Generator, ds: Dataset, class_counts: np.ndarray
) -> List[Dataset]:
    """Materialize per-EU datasets whose class histograms equal class_counts."""
    pools = {c: list(rng.permutation(np.nonzero(ds.y == c)[0])) for c in range(ds.n_classes)}
    shards = []
    for i in range(class_counts.shape[0]):
        take = []
        for c in range(ds.n_classes):
            n = int(class_counts[i, c])
            got = pools[c][:n]
            pools[c] = pools[c][n:]
            take.extend(got)
        shards.append(ds.subset(np.asarray(take, dtype=int)))
    return shards


def class_histogram(labels: np.ndarray, n_classes: int) -> np.ndarray:
    return np.bincount(labels, minlength=n_classes).astype(np.int64)
