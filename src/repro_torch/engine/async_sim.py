"""Event-driven asynchronous HFL engine (straggler-tolerant edge rounds).

The synchronous engines advance in lock-step: every edge round waits for
the slowest participating EU (the straggler effect of paper Sec. 4.2).
Here each EU uploads when *it* finishes — completion times come from an
(M, N) latency matrix, usually ``scenario.cost.latency`` — and an edge
aggregates as soon as a quorum of its EUs has reported:

  * every upload is tagged with the edge-model version it started from;
    stale updates are down-weighted by ``staleness_decay ** staleness``
    (FedAsync-style, Xie et al. '19);
  * the current edge model anchors the average with the weight of the
    EUs that have NOT reported, so a full fresh quorum reduces exactly to
    FedAvg, and ``quorum=1.0, staleness_decay=1.0`` recovers synchronous
    semantics for single-connectivity assignments (modulo wall clock).  A
    DCA client trains once per dispatch, from the mean of its edges'
    models, and its one multicast upload (~3% overhead) reaches every
    member edge; uploads are charged at transmission time;
  * after ``edge_per_cloud`` aggregations an edge reports to the cloud; the
    cloud round closes when every edge has reported (the hierarchy's only
    barrier), and in-flight stragglers are dropped there.

Wall clock is the simulated event time itself: ``SimResult.wall_seconds``
measures what async buys over the synchronous max-latency model.

Edge models live in one (E, D) matrix that owns its storage (a quorum
flush writes one row in place); a heterogeneous-model population keeps one
(E, D_g) matrix per architecture group, flushes average within a group
(the quorum counts reporters of every group), and the cloud barrier fuses
each edge's group models by distillation (``engine.distill``) before one
cloud reduce per group.  Cohorts gather their batches from a
``DeviceShardStore`` (the GEMM-form step).  Every weighted average — the
quorum flushes (N 1-6 rows), the DCA start means and the cloud reduce
(N = edges) — goes through ``flat_mean``, so on the card each is one
``hier_aggregate`` launch.  A flush's weights are new every time, so each
flush uploads them (``weight_uploads`` counts every host-to-device weight
copy); the DCA starts take a ones vector and the fault-free cloud reduce
the edge sizes, both on the device once per run.

``telemetry`` records the reference's wall spans (``cloud_round``,
``assignment``, ``cohort_epoch``, ``edge_aggregate`` per flush,
``kd_fuse``, ``cloud_reduce``, ``eval``) and its simulated-time track
(pid 2 of the exported trace: each ``upload``, ``retry`` and ``abandon``
on its edge's row, and each ``cloud_round`` from its first dispatch to the
post-barrier backhaul), with ``async_staleness``, the fault counters and
``group_clients/<program>``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hfl import CommAccountant, HFLSchedule, ServerMomentum
from repro_torch.data.synthetic_health import Dataset
from repro_torch.device import configure_numerics, resolve_device
from repro_torch.engine.cohort import LocalJob, build_group_state, make_job, run_cohorts
from repro_torch.engine.distill import check_distillable, check_public_shards, distill_fuse_flat, draw_public_batches
from repro_torch.engine.events import EventQueue
from repro_torch.engine.flatten import BACKENDS, FlatPack, compress_flat_upload, flat_mean
from repro_torch.engine.store import DeviceShardStore
from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import as_program, group_edge_sizes
from repro_torch.federated.simulation import (
    RoundMetrics,
    SimResult,
    check_cohort,
    evaluate,
    hetero_final_params,
    initial_params,
)
from repro_torch.telemetry import NULL_TELEMETRY, coerce_telemetry
from repro_torch.telemetry.report import CommDelta
from repro_torch.utils.tree import tree_size_bytes


@dataclasses.dataclass
class _EdgeState:
    """Bookkeeping for one edge; its model is row ``j`` of the engine's
    (E, D) edge matrix."""

    members: List[int]  # participating client indices this cloud round
    version: int = 0
    rounds_done: int = 0
    done_time: float = 0.0
    # buffered uploads: (client_idx, row, data_size, birth_version)
    buffer: List[Tuple[int, torch.Tensor, float, int]] = dataclasses.field(default_factory=list)
    # fault-injected runs: members whose upload to this edge was abandoned
    # (the quorum shrinks to the live population; a later delivery
    # re-registers the EU)
    lost: set = dataclasses.field(default_factory=set)
    # whether any upload was aggregated this cloud round (a starved edge
    # weighs 0 in the degraded cloud reduce)
    got: bool = False


class AsyncHFLEngine:
    """Heap-scheduled async counterpart of ``BatchedSyncEngine``.

    Knobs: ``latency`` ((M, N) per-EU upload latency in seconds, which
    drives the event clock), ``quorum`` (fraction of an edge's members that
    must report before it aggregates, in (0, 1]), ``staleness_decay``
    (weight multiplier per version an upload is behind), ``backend``
    ("kernel" | "reference"), ``compression`` (a ``CompressionSpec``,
    per-client error feedback; it takes precedence over the program's own
    upload quantization), ``faults`` (a ``FaultState``: churn, retry
    cascades, energy, fading), ``cohort`` (a ``CohortSpec``, drawn once per
    cloud round at edge-round key 1, the members the sync engines train in
    their first edge round; needs ``upp=1.0``), ``server_momentum`` (cloud
    momentum on the aggregated delta, one velocity per group),
    ``public_shards`` and ``distill`` (the cloud barrier's distillation
    fuse of a heterogeneous-model population; ignored for a homogeneous
    one), ``telemetry`` (see the module docstring) and ``device``
    (default "cuda"; raises without CUDA unless "cpu").  ``serve`` (a
    ``serving.traffic.ServeTraffic``; one program group only) drives query
    traffic against the global model after each cloud barrier's reduce.

    The engine counts its own weighted averages in ``aggregates``
    (``"flush"``, ``"dca_start"``, ``"cloud_reduce"``: one
    ``hier_aggregate`` launch each on the card), the rows of each flush in
    ``flush_rows`` (N -> count) and its host-to-device weight copies in
    ``weight_uploads`` (a flush or a reduce is per group).
    """

    def __init__(
        self,
        clients: List[FLClient],
        assignment: np.ndarray,
        program,
        test: Dataset,
        latency: np.ndarray,
        schedule: HFLSchedule = HFLSchedule(1, 1),
        seed: int = 0,
        upp: float = 1.0,
        staleness_decay: float = 0.5,
        quorum: float = 0.75,
        backhaul_s: float = 0.05,
        backend: str = "kernel",
        compression=None,
        public_shards=None,
        distill=None,
        faults=None,
        telemetry=None,
        cohort=None,
        server_momentum: float = 0.0,
        serve=None,
        device="cuda",
    ):
        if not (0.0 < quorum <= 1.0):
            raise ValueError(f"quorum must be in (0, 1], got {quorum}")
        check_cohort(cohort, upp)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = resolve_device(device)
        configure_numerics(self.device)
        self.clients = clients
        self.assignment = np.asarray(assignment)
        self.program = as_program(program)
        self.test = test
        self.latency = np.asarray(latency)
        self.schedule = schedule
        self.rng = np.random.default_rng(seed)
        self.upp = upp
        self.cohort = cohort
        self.staleness_decay = staleness_decay
        self.quorum = quorum
        self.backhaul_s = backhaul_s
        self.backend = backend
        self.compression = compression
        self.params = initial_params(self.program, seed, self.device)
        self.pack = FlatPack(self.params)
        # architecture groups: one edge matrix, pack and payload per program
        gs = build_group_state(clients, self.program, self.params, self.pack, seed, compression)
        self.groups, self.group_of = gs.programs, gs.group_of
        self.group_params, self.packs = gs.params, gs.packs
        self._group_bits, self._uplink_bits = gs.bits, gs.uplink_bits
        self._momentum = [ServerMomentum(server_momentum) for _ in self.groups]
        # the serve hook reads the post-barrier global model; its draws come
        # from its own generator, so a serve-on run trains as a serve-off one
        self.serve = serve
        if serve is not None and len(self.groups) > 1:
            raise ValueError(
                "serve traffic targets THE global model; heterogeneous-model "
                "populations have one per architecture group"
            )
        self.distill = distill if len(self.groups) > 1 else None
        self.public_store = None
        if self.distill is not None:
            check_public_shards(public_shards, self.assignment.shape[1])
            check_distillable(self.groups)
            self.public_store = DeviceShardStore.from_shards(public_shards, self.device)
        self.accountant = CommAccountant(model_bits=tree_size_bytes(self.params) * 8)
        self.faults = faults
        self._lat = self.latency  # the round's faded latency under faults
        self._client_edges: Dict[int, List[int]] = {}
        # per-client compression error feedback (a client trains once per
        # dispatch and multicasts one row)
        self._errors: Dict[int, torch.Tensor] = {}
        self.queue = EventQueue()
        self._losses: List[float] = []
        self._edge_mats: Optional[List[torch.Tensor]] = None  # per group, (E, D_g)
        self._ones = torch.ones(self.assignment.shape[1], device=self.device)
        # None when shard sizes are so skewed that padding would cost more
        # memory than the device gather saves: batches are then stacked on
        # the host
        self.store = DeviceShardStore.build_if_economical(clients, self.device)
        self._round = 0
        self.aggregates = {"flush": 0, "dca_start": 0, "cloud_reduce": 0}
        self.flush_rows: collections.Counter = collections.Counter()
        self.weight_uploads = 0
        self.tel = coerce_telemetry(telemetry) or NULL_TELEMETRY
        if self.tel.enabled:
            counts = np.bincount(self.group_of, minlength=len(self.groups))
            for g, prog in enumerate(self.groups):
                self.tel.metrics.set_gauge(f"group_clients/{prog.name}", int(counts[g]))

    # -- weighted averages (one hier_aggregate launch each on the card) -------
    def _upload(self, weights) -> torch.Tensor:
        """Host weights as fp32 on the engine's device: one counted copy."""
        self.weight_uploads += 1
        return torch.as_tensor(np.asarray(weights, np.float32), device=self.device)

    def _flush_mean(self, rows: List[torch.Tensor], weights: List[float]) -> torch.Tensor:
        self.aggregates["flush"] += 1
        self.flush_rows[len(rows)] += 1
        return flat_mean(torch.stack(rows), self._upload(weights), backend=self.backend)

    def _start_mean(self, js: List[int], g: int) -> torch.Tensor:
        """A DCA client's start: the unweighted mean of its edges' models of
        its group ``g``."""
        self.aggregates["dca_start"] += 1
        rows = torch.stack([self._edge_mats[g][j] for j in js])
        return flat_mean(rows, self._ones[: len(js)], backend=self.backend)

    def _cloud_mean(self, g: int, weights: torch.Tensor) -> torch.Tensor:
        self.aggregates["cloud_reduce"] += 1
        return flat_mean(self._edge_mats[g], weights, backend=self.backend)

    # -- dispatch and transmission ------------------------------------------
    def _dispatch(self, client_ids: List[int], edges: Dict[int, _EdgeState]) -> None:
        """Train each client once and multicast its row to every member edge.

        Clients go in index order, so the numpy RNG stream is consumed
        client by client as in the synchronous engines; in the
        ``quorum=1.0`` corner async then reduces to FedAvg.
        """
        client_ids = sorted(client_ids)
        if self.faults is not None:
            alive = self.faults.alive()
            live = []
            for i in client_ids:
                if alive[i]:
                    live.append(i)
                else:
                    # a battery-dead EU never transmits; its edges stop
                    # waiting for it
                    for j in self._client_edges[i]:
                        edges[j].lost.add(i)
                    if self.tel.enabled:
                        self.tel.metrics.inc("faults_dead_skips")
            client_ids = live
        jobs: List[LocalJob] = []
        for i in client_ids:
            g = int(self.group_of[i])
            js = self._client_edges[i]
            start = self._edge_mats[g][js[0]] if len(js) == 1 else self._start_mean(js, g)
            jobs.append(make_job(self.clients[i], start, self.rng, self.schedule.local_steps))
        trained = run_cohorts(jobs, self.program, self.pack, store=self.store, telemetry=self.tel)
        compressing = self.compression is not None and self.compression.kind != "none"
        for i, job in zip(client_ids, jobs):
            g = int(self.group_of[i])
            js = self._client_edges[i]
            upd = trained.row(i)
            self._losses.append(trained.loss[i])
            program = self.clients[i].program
            if not compressing and program.quantizes_upload:
                upd = program.quantize_upload(job.start_flat, upd)
            else:
                upd = compress_flat_upload(self.compression, self._errors, i, job.start_flat, upd)
            # each member edge sent a downlink copy of the group's model; the
            # uplink is ONE multicast (paper: ~3% overhead)
            bits = self._uplink_bits[g]
            mc = self.accountant.dca_multicast_overhead if len(js) > 1 else 0.0
            self.accountant.on_eu_exchange(i, down_bits=self._group_bits[g] * len(js))
            if self.faults is None:
                self.accountant.on_eu_exchange(i, up_bits=bits * (1.0 + mc))
                for j in js:
                    self.queue.push(
                        self.queue.now + float(self._lat[i, j]), "upload",
                        client=i, edge=j, row=upd, birth=edges[j].version,
                    )
                    if self.tel.enabled:
                        # the simulated-time track: the upload holds the
                        # event clock from dispatch until the edge hears it
                        self.tel.sim_span(
                            "upload", self.queue.now, self.queue.now + float(self._lat[i, j]),
                            tid=j + 1, client=i, edge=j,
                        )
            else:
                self._transmit(i, js, upd, edges, bits * (1.0 + mc), bits)

    def _transmit(
        self, i: int, js: List[int], upd: torch.Tensor, edges: Dict[int, _EdgeState],
        mcast_bits: float, unicast_bits: float,
    ) -> None:
        """One multicast under the fault model: each member edge's retry
        cascade is planned at dispatch (``FaultState.plan_upload``) and
        becomes one future "upload" or "lost" event.  Useful bits are
        charged when at least one edge hears the multicast; an abandoned
        multicast and every retransmission are wasted bits."""
        b = self._round
        # attempt 0 is the shared multicast: one debit, costliest edge
        self.faults.debit(i, self.faults.upload_energy(b, i, np.asarray(js)))
        t0 = self.queue.now
        delivered = 0
        for j in js:
            plan = self.faults.plan_upload(b, i, j, float(self._lat[i, j]))
            if self.tel.enabled:
                for (s, e, a) in plan.windows:
                    self.tel.sim_span(
                        "upload" if a == 0 else "retry", t0 + s, t0 + e, tid=j + 1, client=i, edge=j, attempt=a
                    )
                if plan.retries:
                    self.tel.metrics.inc("faults_retries", plan.retries)
            for _ in range(plan.retries):
                self.accountant.on_wasted_upload(i, unicast_bits, kind="retry")
            if plan.ok:
                delivered += 1
                self.queue.push(t0 + plan.t_end, "upload", client=i, edge=j, row=upd, birth=edges[j].version)
            else:
                if self.tel.enabled:
                    self.tel.sim_span(
                        "abandon", t0 + plan.t_end, t0 + plan.t_end, tid=j + 1, client=i, edge=j, reason=plan.reason
                    )
                    self.tel.metrics.inc(f"faults_abandon_{plan.reason}")
                self.queue.push(t0 + plan.t_end, "lost", client=i, edge=j, reason=plan.reason)
        if delivered:
            self.accountant.on_eu_exchange(i, up_bits=mcast_bits)
        else:
            self.accountant.on_wasted_upload(i, mcast_bits, kind="abandoned")

    # -- edges ----------------------------------------------------------------
    def _quorum_count(self, edge: _EdgeState) -> int:
        # abandoned members do not count toward the population the edge
        # waits on (``lost`` is empty without faults)
        return max(1, int(np.ceil(self.quorum * (len(edge.members) - len(edge.lost)))))

    def _settle(self, j: int, edge: _EdgeState, edges: Dict[int, _EdgeState]) -> None:
        """Flush the edge if its buffer now satisfies the (live) quorum."""
        if len(edge.buffer) >= self._quorum_count(edge):
            self._dispatch(self._edge_aggregate(j, edge), edges)

    def _drain_starved(self, edges: Dict[int, _EdgeState]) -> None:
        """The queue is empty but edges are unfinished (fault-injected runs
        only): flush whoever delivered (a degraded flush), and mark edges
        with no delivery as starved — they stop waiting and weigh 0 in the
        cloud reduce."""
        for j, edge in edges.items():
            if edge.rounds_done >= self.schedule.edge_per_cloud:
                continue
            if edge.buffer:
                if self.tel.enabled:
                    self.tel.metrics.inc("faults_degraded_flush")
                self._dispatch(self._edge_aggregate(j, edge), edges)
            else:
                edge.rounds_done = self.schedule.edge_per_cloud
                edge.done_time = self.queue.now
                if self.tel.enabled:
                    self.tel.metrics.inc("faults_starved_edges")

    def _maybe_repair(self, b: int) -> bool:
        """Re-repair the assignment when channel drift invalidated
        memberships; True when it changed."""
        if not self.faults.spec.reassign:
            return False
        new_lam, changed = self.faults.repair(b, self.assignment)
        if len(changed):
            self.assignment = new_lam
            if self.tel.enabled:
                self.tel.metrics.inc("faults_reassigned", int(len(changed)))
        return bool(len(changed))

    def _edge_aggregate(self, j: int, edge: _EdgeState) -> List[int]:
        """Staleness-weighted flush of edge ``j``; returns the clients to
        redispatch.  Uploads average within their architecture group (a CNN
        row cannot average with an MLP row), the group's current edge model
        anchoring for its members that have not reported; a group with no
        upload keeps its model.  The anchor row goes first and the
        reporters follow by client id, so the kernel adds them in the
        reference's order."""
        tel = self.tel
        all_reporters: List[int] = []
        with tel.span(
            "edge_aggregate", engine="async", edge=j, round=self._round, buffered=len(edge.buffer),
            version=edge.version,
        ):
            for g in range(len(self.groups)):
                rows, weights, reporters = [], [], []
                for i, row, size, birth in sorted(edge.buffer, key=lambda u: u[0]):
                    if int(self.group_of[i]) != g:
                        continue
                    staleness = edge.version - birth
                    if tel.enabled:
                        tel.metrics.observe("async_staleness", float(staleness))
                    rows.append(row)
                    weights.append(max(size, 1.0) * self.staleness_decay ** staleness)
                    reporters.append(i)
                if not rows:
                    continue
                reported = set(reporters)
                anchor_w = float(sum(
                    max(self.clients[i].data_size, 1.0)
                    for i in edge.members if int(self.group_of[i]) == g and i not in reported
                ))
                if anchor_w > 0:
                    rows = [self._edge_mats[g][j]] + rows
                    weights = [anchor_w] + weights
                self._edge_mats[g][j] = self._flush_mean(rows, weights)
                all_reporters += reporters
        if edge.buffer:
            edge.got = True
        edge.version += 1
        edge.rounds_done += 1
        edge.buffer = []
        self.accountant.on_edge_round()
        if edge.rounds_done >= self.schedule.edge_per_cloud:
            edge.done_time = self.queue.now
            return []
        # a redispatched client trains once and uploads to all its member
        # edges (deduplicated: a client can buffer twice)
        return sorted(set(all_reporters))

    # -- main loop ------------------------------------------------------------
    def _round_edges(self, participating: np.ndarray) -> Dict[int, _EdgeState]:
        m, n = self.assignment.shape
        edges: Dict[int, _EdgeState] = {}
        for j in range(n):
            st = _EdgeState(members=[i for i in range(m) if self.assignment[i, j] and participating[i]])
            if not st.members:  # nothing to wait for: report at once
                st.rounds_done = self.schedule.edge_per_cloud
                st.done_time = self.queue.now
            edges[j] = st
        return edges

    def run(self, cloud_rounds: int, eval_every: int = 1) -> SimResult:
        m, n = self.assignment.shape
        n_groups = len(self.groups)
        history: List[RoundMetrics] = []
        global_rows = [pk.ravel(t) for pk, t in zip(self.packs, self.group_params)]
        edge_sizes = group_edge_sizes(self.clients, self.assignment, self.group_of)
        edge_sizes_dev = [self._upload(w) for w in edge_sizes]
        cloud_bits = None if n_groups == 1 else float(sum(self._group_bits))
        tel = self.tel
        comm = CommDelta(self.accountant) if tel.enabled else None
        wall_accum = sim_accum = 0.0
        for b in range(1, cloud_rounds + 1):
            t_round = time.perf_counter()
            sim0 = self.queue.now
            self._round = b
            acc = None
            with tel.span("cloud_round", engine="async", round=b):
                self._losses = []
                if self.faults is not None:
                    if self._maybe_repair(b):
                        edge_sizes = group_edge_sizes(self.clients, self.assignment, self.group_of)
                        edge_sizes_dev = [self._upload(w) for w in edge_sizes]
                    # retry deadlines and the event clock read the round's faded channel
                    self._lat = self.faults.latency(b)
                with tel.span("assignment", round=b) as sp:
                    if self.cohort is not None:
                        participating = self.cohort.mask(b, 1, assignment=self.assignment)
                    else:
                        participating = self.rng.random(m) < self.upp
                        if not participating.any():
                            participating[self.rng.integers(0, m)] = True
                    if self.faults is not None:
                        participating &= self.faults.participation(b)
                    # every edge starts the cloud round from its group's
                    # global model, in matrices that own their rows (a flush
                    # writes one in place)
                    self._edge_mats = [row.repeat(n, 1) for row in global_rows]
                    edges = self._round_edges(participating)
                    client_ids = [i for i in range(m) if participating[i] and self.assignment[i].any()]
                    self._client_edges = {
                        i: [int(j) for j in np.nonzero(self.assignment[i])[0]] for i in client_ids
                    }
                    sp.set(
                        participating=int(participating.sum()),
                        pairs=sum(len(v) for v in self._client_edges.values()),
                    )
                if tel.enabled:
                    tel.metrics.set_gauge("participating", int(participating.sum()))
                self._dispatch(client_ids, edges)
                while any(e.rounds_done < self.schedule.edge_per_cloud for e in edges.values()):
                    if not self.queue:
                        if self.faults is None:
                            raise RuntimeError("async engine deadlock: no pending events")
                        self._drain_starved(edges)
                        continue
                    ev = self.queue.pop()
                    j = ev.payload["edge"]
                    edge = edges[j]
                    if edge.rounds_done >= self.schedule.edge_per_cloud:
                        continue  # late straggler: the edge already reported
                    if ev.kind == "lost":
                        # an abandoned upload shrinks the quorum population
                        edge.lost.add(ev.payload["client"])
                        self._settle(j, edge, edges)
                        continue
                    cid = ev.payload["client"]
                    edge.buffer.append(
                        (cid, ev.payload["row"], float(self.clients[cid].data_size), ev.payload["birth"])
                    )
                    edge.lost.discard(cid)
                    self._settle(j, edge, edges)
                if self.faults is not None:
                    self.faults.record_gauges(tel)
                # cloud barrier: every edge reported; drop in-flight stragglers
                self.queue.clear()
                self.queue.now = max(e.done_time for e in edges.values()) + self.backhaul_s
                if tel.enabled:
                    # the same cloud round on the simulated-time track
                    tel.sim_span("cloud_round", sim0, self.queue.now, round=b)
                if self.distill is not None:
                    # fuse each edge's group models on its public shard before
                    # the per-group cloud reduce (edge-local: no EU traffic)
                    idx = draw_public_batches(self.rng, self.public_store.sizes, self.distill)
                    xb = self.public_store.gather(np.arange(n), idx)[0]
                    self._edge_mats, _ = distill_fuse_flat(
                        self.groups, [pk.spec for pk in self.packs], self._edge_mats, xb, self.distill,
                        telemetry=tel,
                    )
                with tel.span("cloud_reduce", round=b, edges=n, groups=n_groups) as sp:
                    cost = tel.jit_cost(
                        "cloud_reduce", lambda u, w: flat_mean(u, w, backend=self.backend),
                        self._edge_mats[0], edge_sizes_dev[0],
                    )
                    if cost:
                        sp.set(**cost)
                    new_rows = list(global_rows)
                    if self.faults is not None:
                        # degraded reduce: starved edges weigh 0; a fully
                        # starved hierarchy keeps every group's global model
                        got = np.array([edges[j].got for j in range(n)], bool)
                        if got.any():
                            new_rows = [
                                self._cloud_mean(g, self._upload(edge_sizes[g] * got)) for g in range(n_groups)
                            ]
                    else:
                        new_rows = [self._cloud_mean(g, edge_sizes_dev[g]) for g in range(n_groups)]
                    global_rows = [self._momentum[g](global_rows[g], new_rows[g]) for g in range(n_groups)]
                self.accountant.on_cloud_sync(n, bits=cloud_bits)
                serve_rec = (
                    self.serve.on_round(b, lambda rows=global_rows: self.packs[0].unravel(rows[0]))
                    if self.serve is not None else {}
                )
                if b % eval_every == 0 or b == cloud_rounds:
                    with tel.span("eval", round=b) as sp:
                        acc = float(np.mean([
                            evaluate(self.packs[g].unravel(global_rows[g]), self.groups[g], self.test)
                            for g in range(n_groups)
                        ]))
                        sp.set(acc=acc)
            round_wall = time.perf_counter() - t_round
            round_sim = self.queue.now - sim0
            wall_accum += round_wall
            sim_accum += round_sim
            loss = float(np.mean(self._losses)) if self._losses else None
            if acc is not None:
                history.append(RoundMetrics(
                    b, acc, 0.0, loss if loss is not None else 0.0, wall_seconds=wall_accum, sim_seconds=sim_accum
                ))
                wall_accum = sim_accum = 0.0
            if tel.enabled:
                if acc is not None:
                    tel.metrics.set_gauge("eval_acc", acc)
                tel.on_round(
                    engine="async", round=b, acc=acc, loss=loss, wall_s=round_wall, sim_s=round_sim, **serve_rec,
                    **comm.take(),
                )
        trees = [pk.unravel(row) for pk, row in zip(self.packs, global_rows)]
        self.params = trees[0] if n_groups == 1 else hetero_final_params(self.groups, trees)
        return SimResult(
            history, self.accountant, self.params, wall_seconds=self.queue.now,
            telemetry=tel if tel.enabled else None,
            serve_history=self.serve.history if self.serve is not None else None,
        )
