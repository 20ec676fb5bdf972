"""Per-round cohort sampling for all engines.

Production FL trains a few-hundred-client cohort per round out of millions
(Pareto-biased ``prate`` selection — PAPERS.md "Federated Learning with
Pareto Optimality for Resource Efficiency").  A :class:`CohortSpec` draws
that cohort from a **keyed side-channel generator**, never from the
engines' training RNG stream — the same pattern ``repro_torch.faults`` uses —
so enabling sampling cannot perturb the draw-for-draw RNG parity that the
golden trajectory pins rely on, and a full-participation run (no cohort)
is bit-identical with or without this module imported.

Draws are pure in ``(spec.seed, cloud_round, edge_round)``: every engine
that asks for round ``(b, er)``'s cohort gets the same member set, which
is what makes reference-vs-sync-vs-async cohort trajectories comparable.

Strategies:
  * ``uniform``  — simple random sample of eligible clients.
  * ``prate``    — Pareto-biased inclusion: per-client weights drawn once
    from a Pareto(alpha) tail (hash-keyed, so weight i is a pure function
    of ``(seed, i)``), sampled without replacement via Gumbel top-k.
  * ``per_edge`` — near-equal quotas across edges (largest-remainder
    split of the cohort size over edges that have eligible members), so
    no edge aggregates from an empty cohort while others overflow.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from repro_torch.utils.seedhash import keyed_uniform

_S_COHORT = 0xC0_4081  # side-channel RNG key tag (cf. repro_torch.faults keying)
_S_PARETO = 0xC0_4082

STRATEGIES = ("uniform", "prate", "per_edge")


@functools.lru_cache(maxsize=8)
def pareto_weights(seed: int, m: int, alpha: float) -> np.ndarray:
    """(M,) float64 Pareto(alpha) participation weights, pure in (seed, i).

    Inverse-CDF transform of a keyed uniform: ``w = (1 - u) ** (-1/alpha)``,
    a heavy tail where a small fraction of clients carries most of the
    selection mass — the ``prate`` imbalance the Pareto-FL line models.
    """
    u = keyed_uniform(seed, _S_PARETO, np.arange(m))
    return (1.0 - u) ** (-1.0 / float(alpha))


def _floyd_sample(rs: np.random.Generator, n: int, k: int) -> np.ndarray:
    """``k`` distinct ints in ``[0, n)`` in O(k) time and memory.

    Floyd's algorithm — ``Generator.choice(n, k, replace=False)`` permutes
    all ``n`` candidates, which is an O(M) allocation *per round* at
    M = 1M; the streaming engine's per-round cost must stay O(cohort).
    """
    chosen = set()
    for j in range(n - k, n):
        t = int(rs.integers(0, j + 1))
        chosen.add(j if t in chosen else t)
    return np.fromiter(chosen, np.int64, k)


def _largest_remainder(total: int, caps: np.ndarray) -> np.ndarray:
    """Split ``total`` into per-bin quotas <= caps, near-equal, deterministic."""
    caps = np.asarray(caps, np.int64)
    quota = np.zeros_like(caps)
    remaining = int(total)
    open_bins = caps > 0
    while remaining > 0 and open_bins.any():
        share = max(1, remaining // int(open_bins.sum()))
        give = np.minimum(np.where(open_bins, share, 0), caps - quota)
        gave = int(give.sum())
        if gave == 0:
            break
        # don't overshoot: trim the tail of this pass to fit `remaining`
        if gave > remaining:
            excess = gave - remaining
            for j in range(len(give) - 1, -1, -1):
                take = min(excess, int(give[j]))
                give[j] -= take
                excess -= take
                if excess == 0:
                    break
        quota += give
        remaining -= int(give.sum())
        open_bins = (caps - quota) > 0
    return quota


@dataclasses.dataclass(frozen=True)
class CohortSpec:
    """Per-round cohort sampling policy.

    ``size`` clients per edge round (fewer if fewer are eligible).  Engines
    require ``upp == 1.0`` alongside a cohort — the UPP Bernoulli draw and
    cohort sampling are both participation models and composing them would
    silently change the RNG stream semantics each pins.
    """

    size: int
    strategy: str = "uniform"
    alpha: float = 1.5  # Pareto tail index for ``prate``
    seed: int = 0

    def __post_init__(self):
        if self.size < 1:
            raise ValueError("cohort size must be >= 1")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown cohort strategy {self.strategy!r}")

    def _rng(self, cloud_round: int, edge_round: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, _S_COHORT, int(cloud_round), int(edge_round))
        )

    # -- draws ---------------------------------------------------------------
    def draw(
        self,
        cloud_round: int,
        edge_round: int,
        *,
        eligible: Optional[np.ndarray],
        edge_of: Optional[np.ndarray] = None,
        m: Optional[int] = None,
    ) -> np.ndarray:
        """Sorted member ids for round ``(cloud_round, edge_round)``.

        ``eligible``: sorted candidate client ids (those with an edge and,
        under faults, currently available) — or ``None`` meaning *every*
        client ``0..m-1`` is eligible, without materializing the (M,) id
        list (the streaming engine's fully-attached fast path; ``m`` is
        then required).  ``edge_of`` maps each client to its (primary)
        edge — required for ``per_edge``.  ``m`` is the population size,
        required for ``prate`` weight indexing (defaults to
        ``eligible.max() + 1``).
        """
        if eligible is None:
            if m is None:
                raise ValueError("eligible=None needs m=")
            q = int(m)
        else:
            eligible = np.asarray(eligible)
            q = len(eligible)
        if q == 0:
            return np.zeros(0, np.int64)
        c = min(self.size, q)
        if c == q:
            if eligible is None:
                return np.arange(q, dtype=np.int64)
            return np.sort(eligible.astype(np.int64, copy=False))
        rs = self._rng(cloud_round, edge_round)
        if self.strategy == "uniform":
            # O(cohort) per draw — the streaming-engine path; prate and
            # per_edge touch O(M) state per draw and suit materialized runs
            pick = _floyd_sample(rs, q, c)
        elif self.strategy == "prate":
            mm = int(m if m is not None else eligible.max() + 1)
            w = pareto_weights(self.seed, mm, self.alpha)
            if eligible is not None:
                w = w[eligible]
            # Gumbel top-k == weighted sampling without replacement
            keys = np.log(w) + rs.gumbel(size=q)
            pick = np.argpartition(keys, q - c)[q - c :]
        else:  # per_edge
            if edge_of is None:
                raise ValueError("per_edge cohort strategy needs edge_of")
            eo = np.asarray(edge_of)
            if eligible is not None:
                eo = eo[eligible]
            n_edges = int(eo.max()) + 1
            caps = np.bincount(eo, minlength=n_edges)
            quota = _largest_remainder(c, caps)
            picks = []
            for j in range(n_edges):  # ascending edge order => deterministic
                if quota[j] == 0:
                    continue
                members_j = np.flatnonzero(eo == j)
                picks.append(members_j[rs.choice(len(members_j), size=int(quota[j]), replace=False)])
            pick = np.concatenate(picks)
        members = pick if eligible is None else eligible[pick]
        return np.sort(np.asarray(members, np.int64))

    def mask(
        self,
        cloud_round: int,
        edge_round: int,
        *,
        assignment: Optional[np.ndarray] = None,
        edge_of: Optional[np.ndarray] = None,
        n_clients: Optional[int] = None,
        eligible: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """(M,) bool participation mask for the round.

        Pass either a dense ``assignment`` (M, N) matrix (materialized
        engines; a client is eligible if it has any edge) or a compact
        ``edge_of`` (M,) int array with ``-1`` for unattached clients
        (streaming engine).  ``eligible`` further restricts candidates
        (e.g. fault availability) — it must be a bool mask over clients.
        """
        if assignment is not None:
            asn = np.asarray(assignment)
            m = asn.shape[0]
            has_edge = asn.sum(axis=1) > 0
            eo = np.argmax(asn, axis=1)  # primary edge for per_edge quotas
        elif edge_of is not None:
            eo = np.asarray(edge_of)
            m = len(eo) if n_clients is None else int(n_clients)
            has_edge = eo >= 0
        else:
            raise ValueError("mask needs assignment= or edge_of=")
        if eligible is not None:
            has_edge = has_edge & np.asarray(eligible, bool)
        ids = np.flatnonzero(has_edge)
        members = self.draw(cloud_round, edge_round, eligible=ids, edge_of=eo, m=m)
        out = np.zeros(m, bool)
        out[members] = True
        return out
