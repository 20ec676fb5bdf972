"""Batched synchronous HFL engine, device pipeline.

The reference's ``BatchedSyncEngine(pipeline="device")`` on PyTorch: the
same RNG stream, participation draws, DCA starts, schedule and accounting,
with the round run as a few fixed-shape device steps:

  * client shards live in a ``DeviceShardStore``; each cohort's batches are
    gathered on the device from int32 sample indices;
  * each same-shape cohort trains in one batched local epoch
    (``engine.cohort``), flat-major: (C, D) rows in and out;
  * every edge's FedAvg (paper eq. 6/8) is ONE ``flat_segment_mean`` call
    over the (P, D) membership-pair matrix (segments = edges; per-round
    participation travels in the weights), and edges with no participant
    keep their previous model;
  * a DCA client starts from the unweighted mean of its edges' models, one
    segment call with segments = clients; under single connectivity the
    starts are a gather of edge rows;
  * the cloud FedAvg (eq. 8/9) reduces the (E, D) edge matrix with
    ``flat_mean``.

With ``backend="kernel"`` (default) both FedAvg reductions run on the
port's CUDA kernels on the card, and on their plain versions on the CPU.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.hfl import CommAccountant, HFLSchedule, WallClock
from repro_torch.data.synthetic_health import Dataset
from repro_torch.device import configure_numerics, resolve_device
from repro_torch.engine.cohort import CohortPlan, _cohort_epoch_flat, build_group_state
from repro_torch.engine.flatten import BACKENDS, FlatPack, flat_mean, flat_segment_mean
from repro_torch.engine.store import DeviceShardStore
from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import as_program, group_edge_sizes
from repro_torch.federated.simulation import RoundMetrics, SimResult, evaluate
from repro_torch.utils.tree import tree_map

PIPELINES = ("device",)


def _segment_agg_keep(upd, seg_ids, weights, has, prev, n_segments: int, backend: str):
    """Per-edge FedAvg, keeping the previous model of edges without a
    participant (their segment comes back as a zero row)."""
    agg = flat_segment_mean(upd, seg_ids, weights, n_segments, backend=backend)
    return torch.where(has[:, None], agg, prev)


class BatchedSyncEngine:
    """Batched synchronous engine over one client program.

    Knobs: ``pipeline`` ("device"; the reference's "host" and "mesh"
    pipelines are not ported yet), ``backend`` ("kernel" | "reference"),
    ``upp`` (per-round participation probability in (0, 1]),
    ``cost_latency`` (an (M, N) latency matrix for the ``WallClock``), and
    ``device`` (default "cuda"; raises without CUDA unless "cpu").

    Initial parameters come from ``program.init`` with a
    ``torch.Generator`` seeded from ``seed``, drawn on the CPU so that the
    card and the CPU start from the same model.
    """

    def __init__(
        self,
        clients: List[FLClient],
        assignment: np.ndarray,
        program,
        test: Dataset,
        schedule: HFLSchedule = HFLSchedule(1, 1),
        seed: int = 0,
        upp: float = 1.0,
        cost_latency=None,
        backend: str = "kernel",
        pipeline: str = "device",
        device="cuda",
    ):
        if pipeline not in PIPELINES:
            raise NotImplementedError(
                f"pipeline={pipeline!r} is not ported yet (ported: {PIPELINES}); "
                "see ROADMAP.md Queue 1"
            )
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = resolve_device(device)
        configure_numerics(self.device)
        self.clients = clients
        self.program = as_program(program)
        self.test = test
        self.schedule = schedule
        self.rng = np.random.default_rng(seed)
        self.upp = upp
        self.backend = backend
        self.pipeline = pipeline
        params = self.program.init(torch.Generator().manual_seed(seed))
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.pack = FlatPack(self.params)
        gs = build_group_state(clients, self.program, self.params, self.pack)
        self.group_of = gs.group_of
        self._uplink_bits = gs.uplink_bits[0]
        self.accountant = CommAccountant(model_bits=gs.bits[0])
        self.clock = WallClock(cost_latency) if cost_latency is not None else None
        self._data_sizes = np.array([c.data_size for c in clients], np.float32)
        self._build_pair_structure(assignment)
        self.store = DeviceShardStore(clients, self.device)
        self._plan = CohortPlan(clients, self.program)

    def _build_pair_structure(self, assignment) -> None:
        """The (client, edge) membership pairs in client-major order and
        the single-connectivity fast-path indices."""
        asn = np.asarray(assignment)
        self.assignment = asn
        pc, pe = np.nonzero(asn)
        self._pair_clients = pc.astype(np.int64)
        self._pair_edges = pe.astype(np.int64)
        dev = self.device
        self._pair_clients_dev = torch.as_tensor(self._pair_clients, device=dev)
        self._pair_edges_dev = torch.as_tensor(self._pair_edges, device=dev)
        self._pair_ones = torch.ones(len(pc), dtype=torch.float32, device=dev)
        self._has_edge = asn.any(axis=1)
        # with single connectivity every start IS an edge row: one gather
        self._single_edge = bool((asn.sum(axis=1) <= 1).all())
        self._client_edge = np.where(self._has_edge, asn.argmax(axis=1), 0).astype(np.int64)

    def _draw_participation(self, m: int) -> np.ndarray:
        """This round's (M,) participation mask, drawn from the engine RNG
        draw for draw like the reference."""
        participating = self.rng.random(m) < self.upp
        if not participating.any():
            participating[self.rng.integers(0, m)] = True
        return participating

    def _cloud_mean(self, edge_mat: torch.Tensor, weights) -> torch.Tensor:
        """Cloud FedAvg of the (E, D) edge matrix (paper eq. 9)."""
        return flat_mean(edge_mat, weights, backend=self.backend)

    def _client_starts(self, edge_mat: torch.Tensor) -> torch.Tensor:
        """(M, D) DCA start rows: each client's unweighted mean of its edges'
        models, one segment call with segments = clients over the pairs."""
        return flat_segment_mean(
            edge_mat[self._pair_edges_dev],
            self._pair_clients_dev,
            self._pair_ones,
            self.assignment.shape[0],
            backend=self.backend,
        )

    def _edge_account(self, participating: np.ndarray) -> None:
        self.accountant.on_edge_sync(
            self.assignment * participating[:, None], uplink_bits=self._uplink_bits
        )
        if self.clock is not None:
            self.clock.on_edge_sync(self.assignment, participating)

    def _edge_round_device(self, edge_mat: torch.Tensor):
        """One edge round; returns the new (E, D) edge matrix and the
        per-cohort (C,) losses (still on the device)."""
        m, n = self.assignment.shape
        participating = self._draw_participation(m)
        active = self._has_edge & participating
        # the plan's draw consumes the RNG in client order, like the reference
        groups, passthrough = self._plan.draw(self.rng, active, self.schedule.local_steps)
        starts_full = None

        def starts_for(ids: np.ndarray) -> torch.Tensor:
            nonlocal starts_full
            if self._single_edge:
                return edge_mat[torch.as_tensor(self._client_edge[ids], device=self.device)]
            if starts_full is None:
                starts_full = self._client_starts(edge_mat)
            return starts_full[torch.as_tensor(ids, device=self.device)]

        mats: List[torch.Tensor] = []
        loss_chunks: List[torch.Tensor] = []
        row_of = np.zeros(m, np.int64)
        offset = 0
        for g in groups:
            flat = starts_for(g.members)
            for e in range(g.epochs):
                xb, yb = self.store.gather(g.members, g.idx[:, e])
                flat, loss = _cohort_epoch_flat(
                    flat, xb, yb, self.pack.spec, g.program, g.steps, g.lr
                )
            mats.append(flat)
            loss_chunks.append(loss)
            row_of[g.members] = np.arange(offset, offset + len(g.members))
            offset += len(g.members)
        if len(passthrough):  # empty shards upload their start row untouched
            mats.append(starts_for(passthrough))
            loss_chunks.append(torch.zeros(len(passthrough), device=self.device))
            row_of[passthrough] = np.arange(offset, offset + len(passthrough))
            offset += len(passthrough)
        if active.any():
            upd_matrix = torch.cat(mats, dim=0) if len(mats) > 1 else mats[0]
            pc, pe = self._pair_clients, self._pair_edges
            part_pairs = participating[pc]
            take = row_of[pc]
            if len(take) == upd_matrix.shape[0] and np.array_equal(take, np.arange(len(take))):
                upd = upd_matrix  # rows already in pair order: skip the gather
            else:
                upd = upd_matrix[torch.as_tensor(take, device=self.device)]
            # edges with no participant keep their previous model
            has = np.bincount(pe, weights=part_pairs, minlength=n) > 0
            w = torch.as_tensor(self._data_sizes[pc] * part_pairs, device=self.device)
            edge_mat = _segment_agg_keep(
                upd, self._pair_edges_dev, w, torch.as_tensor(has, device=self.device),
                edge_mat, n, self.backend,
            )
        self._edge_account(participating)
        return edge_mat, loss_chunks

    def run(self, cloud_rounds: int, eval_every: int = 1) -> SimResult:
        n = self.assignment.shape[1]
        history: List[RoundMetrics] = []
        global_row = self.pack.ravel(self.params)
        # the cloud weights go to the device once per run, so that no cloud
        # round's reduce waits on a host-to-device copy
        edge_sizes = torch.as_tensor(
            group_edge_sizes(self.clients, self.assignment, self.group_of)[0], device=self.device
        )
        wall_accum = sim_accum = 0.0
        for b in range(1, cloud_rounds + 1):
            t_round = time.perf_counter()
            sim0 = self.clock.seconds if self.clock is not None else 0.0
            losses: List[torch.Tensor] = []
            edge_mat = global_row[None, :].expand(n, -1)
            for _ in range(self.schedule.edge_per_cloud):
                edge_mat, chunks = self._edge_round_device(edge_mat)
                losses += chunks
            global_row = self._cloud_mean(edge_mat, edge_sizes)
            self.accountant.on_cloud_sync(n)
            if self.clock is not None:
                self.clock.on_cloud_sync()
            acc = None
            if b % eval_every == 0 or b == cloud_rounds:
                acc = evaluate(self.pack.unravel(global_row), self.program, self.test)
            loss_host = _mean_loss(losses)
            wall_accum += time.perf_counter() - t_round
            sim_accum += (self.clock.seconds - sim0) if self.clock is not None else 0.0
            if acc is not None:
                history.append(
                    RoundMetrics(b, acc, 0.0, loss_host, wall_seconds=wall_accum, sim_seconds=sim_accum)
                )
                wall_accum = sim_accum = 0.0
        self.params = self.pack.unravel(global_row)
        result = SimResult(history, self.accountant, self.params)
        if self.clock is not None:
            result.wall_seconds = self.clock.seconds
        return result


def _mean_loss(chunks: Sequence[torch.Tensor]) -> float:
    """Mean of the per-client losses, in float32 on the host as the
    reference takes it."""
    if not chunks:
        return 0.0
    return float(np.mean(np.concatenate([c.detach().cpu().numpy() for c in chunks])))
