"""Evaluation under traffic: deterministic query streams over the federation.

After each cloud round the engines hand the current global model to a
:class:`ServeTraffic` hook, which hot-swaps it behind a simulated query
stream drawn from the scenario's own client shards and reports queries per
second, the served model's staleness (cloud rounds behind the trainer) and
the serve-side metric next to the training metrics.

Determinism: :class:`TrafficSpec` draws every round's queries from a keyed
side-channel generator, ``default_rng((seed, 0xC04083, round))``, the
reference's draws byte for byte, and never from the engines' training RNG;
the hook only reads the global model.  A run with ``serve=`` on therefore
trains exactly as the same run with it off, and round b's queries are the
same on every engine.

On the card a round's batches are uploaded from pinned memory and scored
without a host wait; their metrics are summed on the device and read once,
after the last batch, which is where the ``serve_qps`` timer stops (it
times the card's work, not the launches).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, upload
from repro_torch.telemetry import NULL_TELEMETRY, coerce_telemetry

_S_TRAFFIC = 0xC0_4083  # side-channel RNG key tag (cf. sampling._S_COHORT)


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Per-cloud-round query traffic against the served global model.

    queries:    queries per cloud round (rounded up to whole ``batch``es, so
                the serve path sees one batch shape).
    batch:      serve batch size.
    swap_every: hot-swap cadence in cloud rounds: 1 (default) swaps every
                round (staleness 0); k > 1 serves a model up to k-1 rounds
                stale.
    seed:       side-channel seed; draws are pure in ``(seed, cloud_round)``.
    """

    queries: int = 64
    batch: int = 32
    swap_every: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.queries < 1:
            raise ValueError(f"queries must be >= 1, got {self.queries}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.swap_every < 1:
            raise ValueError(f"swap_every must be >= 1, got {self.swap_every}")

    def n_queries(self) -> int:
        """Queries actually served per round (rounded up to full batches)."""
        return -(-self.queries // self.batch) * self.batch

    def draw(self, cloud_round: int, sizes) -> tuple:
        """(client_ids, sample_idx) of round ``cloud_round``'s queries.

        ``sizes``: (M,) samples per client shard.  Each query picks a client
        uniformly among the non-empty shards, then a sample within it.
        """
        sizes = np.asarray(sizes, np.int64)
        elig = np.flatnonzero(sizes > 0)
        if len(elig) == 0:
            raise ValueError("no non-empty client shards to draw traffic from")
        rng = np.random.default_rng((self.seed, _S_TRAFFIC, int(cloud_round)))
        n = self.n_queries()
        cids = elig[rng.integers(0, len(elig), size=n)]
        idx = rng.integers(0, sizes[cids])
        return cids, idx


class ServeTraffic:
    """Round hook: swap the global model in, drive one round of traffic.

    Built by ``Scenario.simulate(serve=TrafficSpec(...))`` and called by the
    engines after each cloud reduce as ``on_round(cloud_round, params_fn)``;
    ``params_fn`` builds the global parameter tree (views of the engine's
    flat global row) and is called only on swap rounds.  Returns the
    round's record (``serve_qps``, ``serve_staleness_rounds``,
    ``serve_acc``), which the engines merge into their telemetry round
    record; every round's record, with its ``round`` and ``queries``, is
    appended to :attr:`history` (``SimResult.serve_history``).  Telemetry
    records the spans ``serve_round`` and ``swap`` and the three gauges.
    ``device`` is the engine's: "cuda" by default, raising without CUDA
    unless "cpu".
    """

    def __init__(self, spec: TrafficSpec, clients, program, telemetry=None, device="cuda"):
        from repro_torch.federated.programs import as_program

        self.spec = spec
        self.program = as_program(program)
        self.device = resolve_device(device)
        self.tel = coerce_telemetry(telemetry) or NULL_TELEMETRY
        self.shards = [c.shard for c in clients]
        self.sizes = np.asarray([len(s) for s in self.shards], np.int64)
        self._params = None
        self._last_swap: Optional[int] = None
        self.history: List[dict] = []

    def _gather(self, cids, idx) -> tuple:
        x = np.stack([self.shards[c].x[i] for c, i in zip(cids, idx)])
        y = np.asarray([self.shards[c].y[i] for c, i in zip(cids, idx)], self.shards[cids[0]].y.dtype)
        return upload(x, self.device), upload(y, self.device)

    def on_round(self, cloud_round: int, params_fn: Callable[[], dict]) -> dict:
        b = int(cloud_round)
        tel = self.tel
        with tel.span("serve_round", round=b) as sp:
            if self._params is None or b - self._last_swap >= self.spec.swap_every:
                with tel.span("swap", round=b):
                    self._params = params_fn()
                    self._last_swap = b
            staleness = b - self._last_swap
            cids, idx = self.spec.draw(b, self.sizes)
            n = len(cids)
            t0 = time.perf_counter()
            accs = []
            with torch.no_grad():
                for s in range(0, n, self.spec.batch):
                    x, y = self._gather(cids[s:s + self.spec.batch], idx[s:s + self.spec.batch])
                    accs.append(self.program.metric(self._params, x, y))
                # the reference's mean of the batch metrics in float64; the
                # one read of the round, after its last batch
                acc = float(torch.stack(accs).to(torch.float64).mean())
            dt = max(time.perf_counter() - t0, 1e-9)
            rec = {
                "serve_qps": n / dt,
                "serve_staleness_rounds": float(staleness),
                "serve_acc": acc,
            }
            sp.set(queries=n, **rec)
        if tel.enabled:
            for k, v in rec.items():
                tel.metrics.set_gauge(k, v)
        self.history.append({"round": b, "queries": n, **rec})
        return rec
