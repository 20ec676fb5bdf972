"""Hierarchical FL aggregation schedule and accounting (paper Sec. 4.1).

``HFLSchedule`` says when an edge / cloud sync fires; ``CommAccountant``
converts sync events into per-EU and edge<->cloud traffic (the quantities
of paper Figs. 5/6); ``WallClock`` models a synchronous round's latency.
Plain numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


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


@dataclasses.dataclass
class CommAccountant:
    """Counts rounds and bits as the paper's Figs. 5-6 do.

    * EU->edge: every edge sync, each EU uploads |W| bits and downloads |W|
      bits per edge; an EU on two edges (DCA) uploads once by multicast at
      ``dca_multicast_overhead`` extra.
    * edge->cloud: every cloud sync, each edge exchanges |W| up + |W| down.
    """

    model_bits: float
    dca_multicast_overhead: float = 0.03

    edge_rounds: int = 0
    cloud_rounds: int = 0
    eu_bits_up: Dict[int, float] = dataclasses.field(default_factory=dict)
    eu_bits_down: Dict[int, float] = dataclasses.field(default_factory=dict)
    edge_cloud_bits: float = 0.0

    def on_edge_sync(
        self,
        assignment: np.ndarray,
        uplink_bits: "float | None" = None,
        downlink_bits: "float | None" = None,
        count_round: bool = True,
    ) -> None:
        """One synchronous edge round over the (M, N) assignment rows of the
        EUs that took part (a zero row charges nothing)."""
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
            self.eu_bits_up[i] = self.eu_bits_up.get(i, 0.0) + up
            self.eu_bits_down[i] = self.eu_bits_down.get(i, 0.0) + down

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
