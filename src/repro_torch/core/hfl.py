"""Hierarchical FL aggregation schedule and accounting (paper Sec. 4.1).

* edge aggregation (eq. 6-7):  w_j^a   = sum_i sigma_ij w_i^{a T'}
* cloud aggregation (eq. 8-9): w_f^b   = sum_j sigma_j  w_j^{b T}
* divergence tracking (eq. 17 empirical counterpart): ||w_f - w_c||

``HFLSchedule`` says when an edge / cloud sync fires; ``CommAccountant``
converts sync events into per-EU and edge<->cloud traffic (the quantities
of paper Figs. 5/6); ``WallClock`` models a synchronous round's latency.
The schedule, accountant and clock are plain numpy, as in the reference;
the aggregations are plain PyTorch contractions over parameter trees.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.utils.tree import tree_add, tree_l2_norm, tree_map, tree_sub, tree_weighted_mean


@dataclasses.dataclass(frozen=True)
class HFLSchedule:
    """T' local steps per edge sync; T edge syncs per cloud sync."""

    local_steps: int = 1  # T'
    edge_per_cloud: int = 1  # T

    @property
    def cloud_period(self) -> int:
        return self.local_steps * self.edge_per_cloud

    def edge_sync_at(self, step: int) -> bool:
        """1-indexed step count: sync after every T' local steps."""
        return step % self.local_steps == 0

    def cloud_sync_at(self, step: int) -> bool:
        return step % self.cloud_period == 0


def edge_aggregate(models: Sequence, data_sizes: Sequence[float]):
    """eq. 6: weighted average by local dataset size sigma_ij (eq. 7); the
    sizes pass through float64 to float32, as in the reference."""
    return tree_weighted_mean(models, np.asarray(data_sizes, dtype=np.float64))


def cloud_aggregate(edge_models: Sequence, edge_data_sizes: Sequence[float]):
    """eq. 8: weighted average across edges by sigma_j (eq. 9)."""
    return tree_weighted_mean(edge_models, np.asarray(edge_data_sizes, dtype=np.float64))


def weight_divergence(w_f, w_c) -> float:
    """Empirical ||w_f - w_c|| of eq. 17's left-hand side."""
    return float(tree_l2_norm(tree_sub(w_f, w_c)))


class ServerMomentum:
    """Cloud momentum on the aggregated delta, in delta form:
    ``v <- mu * v + (new - old)``, then ``old + v``, over a parameter tree
    or a flat row.  With FedSGD's single-step clients this is centralized
    SGD with momentum on the aggregated gradient.  A model that stood
    (``new is old``: every edge starved all cloud round under faults)
    skips the update rather than decaying ``v`` with a zero delta, as in
    the reference.  ``mu = 0`` returns ``new`` untouched."""

    def __init__(self, mu: float):
        self.mu = float(mu)
        self.velocity = None

    def __call__(self, old, new):
        if not self.mu or new is old:
            return new
        delta = tree_sub(new, old)
        if self.velocity is None:
            self.velocity = delta
        else:
            self.velocity = tree_map(lambda v, d: self.mu * v + d, self.velocity, delta)
        return tree_add(old, self.velocity)


@dataclasses.dataclass
class CommAccountant:
    """Counts rounds and bits as the paper's Figs. 5-6 do.

    * EU->edge: every edge sync, each EU uploads |W| bits and downloads |W|
      bits per edge; an EU on two edges (DCA) uploads once by multicast at
      ``dca_multicast_overhead`` extra.
    * edge->cloud: every cloud sync, each edge exchanges |W| up + |W| down.
    * wasted traffic (fault-injected runs): uploads dropped mid-round,
      async retransmissions and abandoned multicasts go to
      ``eu_bits_wasted``, apart from the useful ``eu_bits_up``.
    """

    model_bits: float
    dca_multicast_overhead: float = 0.03

    edge_rounds: int = 0
    cloud_rounds: int = 0
    eu_bits_up: Dict[int, float] = dataclasses.field(default_factory=dict)
    eu_bits_down: Dict[int, float] = dataclasses.field(default_factory=dict)
    edge_cloud_bits: float = 0.0
    # failure taxonomy (all zero on fault-free runs)
    eu_bits_wasted: Dict[int, float] = dataclasses.field(default_factory=dict)
    dropped_uploads: int = 0
    retried_uploads: int = 0
    abandoned_uploads: int = 0

    def on_edge_sync(
        self,
        assignment: np.ndarray,
        uplink_bits: "float | None" = None,
        downlink_bits: "float | None" = None,
        count_round: bool = True,
        row_ids: "np.ndarray | None" = None,
    ) -> None:
        """One synchronous edge round over the (M, N) assignment rows of the
        EUs that took part (a zero row charges nothing).  ``row_ids`` maps
        the rows to client ids: the streaming engine charges a compact
        (cohort, N) matrix, not the (M, N) population matrix."""
        if count_round:
            self.edge_rounds += 1
        payload = self.model_bits if uplink_bits is None else uplink_bits
        down_payload = self.model_bits if downlink_bits is None else downlink_bits
        for i in range(assignment.shape[0]):
            edges = np.nonzero(assignment[i])[0]
            if len(edges) == 0:
                continue
            up = payload * (1.0 + (self.dca_multicast_overhead if len(edges) > 1 else 0.0))
            down = down_payload * len(edges)
            key = i if row_ids is None else int(row_ids[i])
            self.eu_bits_up[key] = self.eu_bits_up.get(key, 0.0) + up
            self.eu_bits_down[key] = self.eu_bits_down.get(key, 0.0) + down

    def on_eu_exchange(self, i: int, up_bits: float = 0.0, down_bits: float = 0.0) -> None:
        """One EU<->edge exchange (the async engine's uploads and dispatches
        are per EU, not per round)."""
        if up_bits:
            self.eu_bits_up[i] = self.eu_bits_up.get(i, 0.0) + up_bits
        if down_bits:
            self.eu_bits_down[i] = self.eu_bits_down.get(i, 0.0) + down_bits

    def on_wasted_upload(self, i: int, bits: float, kind: str = "dropped") -> None:
        """A transmission that reached no aggregation: "dropped" (a sync
        upload lost mid-air), "retry" (an async retransmission; the payload
        finally delivered is charged once by ``on_eu_exchange``) or
        "abandoned" (a multicast no edge received)."""
        if kind == "dropped":
            self.dropped_uploads += 1
        elif kind == "retry":
            self.retried_uploads += 1
        elif kind == "abandoned":
            self.abandoned_uploads += 1
        else:
            raise ValueError(f"unknown wasted-upload kind {kind!r}")
        self.eu_bits_wasted[i] = self.eu_bits_wasted.get(i, 0.0) + bits

    def on_edge_round(self) -> None:
        self.edge_rounds += 1

    def on_cloud_sync(self, n_edges: int, bits: "float | None" = None) -> None:
        self.cloud_rounds += 1
        payload = self.model_bits if bits is None else bits
        self.edge_cloud_bits += 2.0 * payload * n_edges

    def eu_traffic_bits(self) -> Dict[int, float]:
        keys = set(self.eu_bits_up) | set(self.eu_bits_down)
        return {
            i: self.eu_bits_up.get(i, 0.0) + self.eu_bits_down.get(i, 0.0) for i in keys
        }

    def totals(self) -> Dict[str, float]:
        return {
            "eu_up_bits": float(sum(self.eu_bits_up.values())),
            "eu_down_bits": float(sum(self.eu_bits_down.values())),
            "cloud_bits": float(self.edge_cloud_bits),
            "edge_rounds": float(self.edge_rounds),
            "cloud_rounds": float(self.cloud_rounds),
            "wasted_bits": float(sum(self.eu_bits_wasted.values())),
            "dropped_uploads": float(self.dropped_uploads),
            "retried_uploads": float(self.retried_uploads),
            "abandoned_uploads": float(self.abandoned_uploads),
        }


@dataclasses.dataclass
class WallClock:
    """Synchronous-round wall-clock model (paper Sec. 4.2 / eq. 10).

    Every edge round costs max_i (T_i^c + L_ij) over the participating EUs
    (the straggler waits for the slowest); a cloud sync adds a fixed
    backhaul latency.
    """

    latency: np.ndarray  # (M, N) total per-EU upload latency incl. compute
    backhaul_s: float = 0.05
    seconds: float = 0.0

    def on_edge_sync(self, assignment, participating=None) -> float:
        lam = np.asarray(assignment)
        m = lam.shape[0]
        mask = np.ones(m, bool) if participating is None else np.asarray(participating)
        worst = 0.0
        for i in range(m):
            if not mask[i]:
                continue
            edges = np.nonzero(lam[i])[0]
            if len(edges) == 0:
                continue
            worst = max(worst, float(np.min(self.latency[i, edges])))
        self.seconds += worst
        return worst

    def on_cloud_sync(self) -> float:
        self.seconds += self.backhaul_s
        return self.backhaul_s
