"""Batched synchronous HFL engine.

The reference's ``BatchedSyncEngine`` on PyTorch: the same RNG stream,
participation draws, DCA starts, schedule, accounting and divergence
tracking as the readable simulator (``federated.simulation``), over any
ported ``ClientProgram`` (the CNN, the MLP, FedSGD over either), with the
round run one of two ways (``pipeline=``):

``"device"`` (default) — a few fixed-shape device steps per round:

  * client shards live in a ``DeviceShardStore``; each cohort's batches are
    gathered on the device from int32 sample indices;
  * each same-shape cohort trains in one batched local epoch
    (``engine.cohort``, the GEMM-form forward), flat-major: (C, D) rows in
    and out;
  * every edge's FedAvg (paper eq. 6/8) is ONE ``flat_segment_mean`` call
    over the (P, D) membership-pair matrix (segments = edges; per-round
    participation travels in the weights), and edges with no participant
    keep their previous model;
  * a DCA client starts from the unweighted mean of its edges' models, one
    segment call with segments = clients; under single connectivity the
    starts are a gather of edge rows.

``"host"`` — the host-major loop the reference keeps as its baseline:
per-client ``LocalJob``s drawn in client order, batches stacked from the
numpy shards, cohorts trained through ``run_cohorts`` with the library
convolution (``impl="xla"``), then one ``flat_mean`` per edge that got
uploads; a DCA start is one ``flat_mean`` over the client's edge rows.

Both pipelines end the cloud round with ``flat_mean`` over the (E, D) edge
matrix (eq. 8/9).  With ``backend="kernel"`` (default) the FedAvg
reductions run on the port's CUDA kernels on the card, and on their plain
versions on the CPU.

``compression`` (a ``CompressionSpec``) compresses each participant's flat
(D,) delta with per-client error feedback (one global top-k, not the
readable simulator's per-leaf one; the device pipeline does all rows of a
round in one batched sort).  ``faults`` (a ``FaultState``) masks churned-out
and battery-dead EUs out of a round, gives the uploads it loses weight 0
(charged as wasted, neither compressed nor fed back), debits energy,
re-repairs the assignment under drift (rebuilding the pair structure and
re-uploading the cloud weights) and weighs edges that received nothing
all cloud round 0 in the cloud reduce, by a mask kept on the device.

``cohort`` (a ``CohortSpec``) trains only the spec's sampled members each
edge round, drawn from its keyed side-channel generator in place of the UPP
draw (the engine RNG is not consumed); ``server_momentum`` applies cloud
momentum to the aggregated delta of the global row.

Heterogeneous-model federation: clients may carry different programs.
Every structure above is then kept per architecture group (one (E, D_g)
edge matrix, the group's membership pairs, one segment launch per group
per edge round, one cloud reduce per group, one starved-edge mask and one
momentum velocity per group), and once per cloud round, between the edge
rounds and the cloud reduce, each edge's group models are fused by logit
distillation on its public shard (``engine.distill``; ``distill=`` and
``public_shards=``).  A homogeneous population is the one-group corner of
the same code, so its runs are those of the single-program engine.
Inside a device-pipeline edge round the host uploads from pinned memory
and never waits for the card.

``telemetry`` records the reference's spans: ``cloud_round`` around each
cloud round, ``assignment`` (the participation and batch draws),
``cohort_epoch`` per cohort (with the analytic cost of its first epoch),
``edge_aggregate`` around each group's segment launch (device pipeline) or
the per-edge ``flat_mean`` loop (host pipeline), ``kd_fuse``,
``cloud_reduce`` and ``eval``; the ``participating`` gauge, the cohort and
fault metrics, and one record per cloud round.  Spans time the host's
dispatch and never synchronise; a telemetry-on device round still makes
the host wait for nothing.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.hfl import CommAccountant, HFLSchedule, ServerMomentum, WallClock, weight_divergence
from repro_torch.data.synthetic_health import Dataset
from repro_torch.device import configure_numerics, resolve_device, upload
from repro_torch.engine.cohort import (
    CohortPlan,
    _cohort_epoch_flat,
    build_group_state,
    make_job,
    run_cohorts,
)
from repro_torch.engine.distill import check_distillable, check_public_shards, distill_fuse_flat, draw_public_batches
from repro_torch.engine.flatten import (
    BACKENDS,
    FlatPack,
    compress_flat_rows,
    compress_flat_upload,
    flat_mean,
    flat_segment_mean,
)
from repro_torch.engine.store import DeviceShardStore
from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import as_program, group_edge_sizes
from repro_torch.federated.simulation import (
    RoundMetrics,
    SimResult,
    central_reference_step,
    check_cohort,
    evaluate,
    hetero_final_params,
    initial_params,
    pooled_dataset,
)
from repro_torch.telemetry import NULL_TELEMETRY, coerce_telemetry
from repro_torch.telemetry.report import CommDelta
from repro_torch.utils.tree import tree_size_bytes

PIPELINES = ("device", "host")


def _segment_agg_keep(upd, seg_ids, weights, has, prev, n_segments: int, backend: str):
    """Per-edge FedAvg, keeping the previous model of edges without a
    participant (their segment comes back as a zero row)."""
    agg = flat_segment_mean(upd, seg_ids, weights, n_segments, backend=backend)
    return torch.where(has[:, None], agg, prev)


class BatchedSyncEngine:
    """Batched synchronous engine.

    Knobs: ``pipeline`` ("device" | "host"), ``backend ("kernel" | "reference"), ``upp`` (per-round
    participation probability in (0, 1]), ``track_divergence`` (the
    distance to a virtual centralized model, eq. 17, stepped from the
    engine RNG after each cloud reduce as in the reference; one program
    group only), ``cost_latency`` (an (M, N) latency matrix for the
    ``WallClock``), ``compression``, ``faults``, ``cohort`` and
    ``server_momentum`` (see the module docstring; a cohort needs
    ``upp=1.0``), ``public_shards`` and ``distill`` (the distillation fuse
    of a heterogeneous-model population: one public ``Dataset`` per edge
    and a ``DistillSpec``; ignored for a homogeneous one), ``telemetry``
    (True, a directory or a ``Telemetry``; see the module docstring),
    ``serve`` (a ``serving.traffic.ServeTraffic``, one program group only:
    query traffic against the global model after each cloud reduce) and
    ``device`` (default "cuda"; raises without CUDA unless "cpu").

    ``program`` is the engine's own program; the clients may carry others,
    and the population then splits into one group per program (the
    engine's program must be one of them).  Initial parameters come from
    each program's ``init`` with a ``torch.Generator`` seeded from
    ``seed``, drawn on the CPU, as the readable simulator draws them.
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
        track_divergence: bool = False,
        central_batch: int = 50,
        cost_latency=None,
        backend: str = "kernel",
        compression=None,
        pipeline: str = "device",
        public_shards=None,
        distill=None,
        faults=None,
        cohort=None,
        server_momentum: float = 0.0,
        telemetry=None,
        serve=None,
        device="cuda",
    ):
        if pipeline not in PIPELINES:
            raise ValueError(f"pipeline must be one of {PIPELINES}, got {pipeline!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        check_cohort(cohort, upp)
        self.device = resolve_device(device)
        configure_numerics(self.device)
        self.tel = coerce_telemetry(telemetry) or NULL_TELEMETRY
        self.clients = clients
        self.program = as_program(program)
        self.test = test
        self.schedule = schedule
        self.rng = np.random.default_rng(seed)
        self.upp = upp
        self.cohort = cohort
        self.backend = backend
        self.pipeline = pipeline
        self.params = initial_params(self.program, seed, self.device)
        self.pack = FlatPack(self.params)
        self.compression = compression
        # architecture groups: one of everything below per distinct program
        gs = build_group_state(clients, self.program, self.params, self.pack, seed, compression)
        self.groups, self.group_of = gs.programs, gs.group_of
        self.group_params, self.packs = gs.params, gs.packs
        self._group_bits, self._uplink_bits = gs.bits, gs.uplink_bits
        self._group_index = {p: g for g, p in enumerate(self.groups)}
        n_groups = len(self.groups)
        self._momentum = [ServerMomentum(server_momentum) for _ in range(n_groups)]
        # the serve hook reads the post-reduce global model; its draws come
        # from its own generator, so a serve-on run trains as a serve-off one
        self.serve = serve
        if serve is not None and n_groups > 1:
            raise ValueError(
                "serve traffic targets THE global model; heterogeneous-model "
                "populations have one per architecture group"
            )
        self.distill = distill if n_groups > 1 else None
        self.public_store = None
        if self.distill is not None:
            check_public_shards(public_shards, np.asarray(assignment).shape[1])
            check_distillable(self.groups)
            self.public_store = DeviceShardStore.from_shards(public_shards, self.device)
        self.accountant = CommAccountant(model_bits=tree_size_bytes(self.params) * 8)
        self.clock = WallClock(cost_latency) if cost_latency is not None else None
        self.track_divergence = track_divergence
        if track_divergence:
            if n_groups > 1:
                raise ValueError(
                    "track_divergence is defined against ONE virtual central model; "
                    "heterogeneous-model populations have no such reference"
                )
            self.central_params = self.params
            self.central_data = pooled_dataset(clients, self.program.n_classes)
            self.central_batch = central_batch
        self.faults = faults
        self._round = 0
        self._er = 0  # edge round within the current cloud round
        # fault-injected runs: per group, the edges that aggregated an upload
        # this cloud round, on the host and as a device mask
        self._edge_got = None
        self._got_dev = None
        self._errors: Dict[int, torch.Tensor] = {}  # compression error feedback
        self._data_sizes = np.array([c.data_size for c in clients], np.float32)
        self._build_pair_structure(assignment)
        if pipeline == "device":
            self.store = self._make_store(clients)
            self._plan = CohortPlan(clients, self.program)
        else:
            # the host pipeline's FedAvg weights, on the device once per run:
            # an edge's weights are stacked from views of these rows, so no
            # call uploads from the host or waits for the card
            self._sizes_dev = torch.as_tensor(self._data_sizes, device=self.device)
            self._ones_dev = torch.ones(self.assignment.shape[1], device=self.device)
        if self.tel.enabled:
            for g, prog in enumerate(self.groups):
                self.tel.metrics.set_gauge(f"group_clients/{prog.name}", int((self.group_of == g).sum()))

    def _build_pair_structure(self, assignment) -> None:
        """The (client, edge) membership pairs in client-major order, their
        restriction to each architecture group (a group's segment launch
        sees only its own clients' rows) and the single-connectivity
        fast-path indices."""
        asn = np.asarray(assignment)
        self.assignment = asn
        pc, pe = np.nonzero(asn)
        self._pair_clients = pc.astype(np.int64)
        self._pair_edges = pe.astype(np.int64)
        dev = self.device
        self._pair_clients_dev = upload(self._pair_clients, dev)
        self._pair_edges_dev = upload(self._pair_edges, dev)
        self._pair_ones = torch.ones(len(pc), dtype=torch.float32, device=dev)
        self._gpairs = []
        for g in range(len(self.groups)):
            gm = self.group_of[pc] == g
            pe_g = self._pair_edges[gm]
            self._gpairs.append((self._pair_clients[gm], pe_g, upload(pe_g, dev)))
        self._has_edge = asn.any(axis=1)
        # with single connectivity every start IS an edge row: one gather
        self._single_edge = bool((asn.sum(axis=1) <= 1).all())
        self._client_edge = np.where(self._has_edge, asn.argmax(axis=1), 0).astype(np.int64)

    @property
    def engine_name(self) -> str:
        """The ``engine`` field of the cloud round's span and record."""
        return f"sync-{self.pipeline}"

    def _make_store(self, clients: List[FLClient]) -> DeviceShardStore:
        """The device pipeline's shard store: every client's shard (the mesh
        engine overrides this to upload only its rank's clients)."""
        return DeviceShardStore(clients, self.device)

    def _maybe_repair(self, b: int) -> bool:
        """Re-repair the assignment when channel drift invalidated
        memberships, rebuilding the pair structure; True when it changed."""
        if not self.faults.spec.reassign:
            return False
        new_lam, changed = self.faults.repair(b, self.assignment)
        if len(changed):
            self._build_pair_structure(new_lam)
            if self.tel.enabled:
                self.tel.metrics.inc("faults_reassigned", int(len(changed)))
        return bool(len(changed))

    def _draw_participation(self, m: int):
        """This round's (M,) participation mask, and under faults the (M,)
        mask of uploads lost mid-round (else None).  A cohort is drawn from
        its keyed side channel (the engine RNG is untouched); the UPP draw
        consumes the engine RNG draw for draw like the reference."""
        if self.cohort is not None:
            participating = self.cohort.mask(self._round, self._er, assignment=self.assignment)
        else:
            participating = self.rng.random(m) < self.upp
            if not participating.any():
                participating[self.rng.integers(0, m)] = True
        failed = None
        if self.faults is not None:
            # churned-out and battery-dead EUs sit the round out; lost
            # uploads train but are masked from aggregation.  Keyed fault
            # streams only: the engine RNG above is untouched.
            participating &= self.faults.participation(self._round)
            failed = self.faults.failed_uploads(self._round, self._er) & participating & self._has_edge
            if self.tel.enabled:
                self.tel.metrics.inc("faults_dropped", int(failed.sum()))
        return participating, failed

    def _broadcast_rows(self, global_rows: List[torch.Tensor], n: int) -> List[torch.Tensor]:
        """Per-group (E, D) edge matrices seeded from the global rows at the
        top of a cloud round (the mesh engine's hold its rank's edges)."""
        return [row[None, :].expand(n, -1) for row in global_rows]

    def _cloud_mean(self, edge_mat: torch.Tensor, weights) -> torch.Tensor:
        """Cloud FedAvg of one group's (E, D) edge matrix (paper eq. 9); the
        mesh engine's is a partial sum per rank and one ``all_reduce``."""
        return flat_mean(edge_mat, weights, backend=self.backend)

    def _mean_loss(self, chunks: Sequence[torch.Tensor]) -> float:
        """The cloud round's mean local loss from its device-pipeline loss
        chunks (the mesh engine gathers every rank's first)."""
        return _mean_loss(chunks)

    def _client_starts(self, edge_mat: torch.Tensor) -> torch.Tensor:
        """(M, D) DCA start rows: each client's unweighted mean of its edges'
        models, one segment call with segments = clients over the pairs
        (the rows of clients outside ``edge_mat``'s group are never read)."""
        return flat_segment_mean(
            edge_mat[self._pair_edges_dev],
            self._pair_clients_dev,
            self._pair_ones,
            self.assignment.shape[0],
            backend=self.backend,
        )

    def _edge_account(self, participating: np.ndarray, failed) -> None:
        """Charge one edge round: each group's EUs pay that group's uplink
        and downlink (one masked ``on_edge_sync`` per group; the round
        counts once).  A lost upload leaves the useful totals and is
        charged as wasted bits; the straggler clock and the energy debit
        still see every EU that attempted."""
        success = participating if failed is None else participating & ~failed
        n_groups = len(self.groups)
        for g in range(n_groups):
            mask = (self.group_of == g) & success
            self.accountant.on_edge_sync(
                self.assignment * mask[:, None],
                uplink_bits=self._uplink_bits[g],
                downlink_bits=None if n_groups == 1 else self._group_bits[g],
                count_round=(g == 0),
            )
        if failed is not None:
            mc = self.accountant.dca_multicast_overhead
            for i in np.nonzero(failed)[0]:
                k = int(np.count_nonzero(self.assignment[i]))
                if k:
                    self.accountant.on_wasted_upload(
                        int(i), self._uplink_bits[self.group_of[i]] * (1.0 + (mc if k > 1 else 0.0)), kind="dropped"
                    )
        if self.faults is not None:
            self.faults.debit_round(self._round, participating, self.assignment)
            self.faults.record_gauges(self.tel)
        if self.clock is not None:
            self.clock.on_edge_sync(self.assignment, participating)

    def _edge_round_device(self, edge_mats: List[torch.Tensor]):
        """One edge round; returns the new per-group (E, D_g) edge matrices
        and the per-cohort (C,) losses (still on the device).  Every index
        and weight goes to the card from pinned memory, so the host never
        waits for it here."""
        m, n = self.assignment.shape
        dev, tel = self.device, self.tel
        with tel.span("assignment", round=self._round, engine="sync-device"):
            participating, failed = self._draw_participation(m)
            active = self._has_edge & participating
            # the plan's draw consumes the RNG in client order, like the reference
            groups, passthrough = self._plan.draw(self.rng, active, self.schedule.local_steps)
            if tel.enabled:
                tel.metrics.set_gauge("participating", int(active.sum()))
                for grp in groups:
                    tel.metrics.observe("cohort_size", len(grp.members))
                    need = float(grp.steps * grp.batch)
                    occ = np.minimum(self._plan.sizes[grp.members], need) / need
                    tel.metrics.observe("cohort_padding_waste", float(1.0 - occ.mean()))
        starts_full: Dict[int, torch.Tensor] = {}

        def starts_for(ids: np.ndarray, g: int) -> torch.Tensor:
            if self._single_edge:
                return edge_mats[g][upload(self._client_edge[ids], dev)]
            if g not in starts_full:
                starts_full[g] = self._client_starts(edge_mats[g])
            return starts_full[g][upload(ids, dev)]

        # cohorts and rows are kept per architecture group throughout
        mats: List[List[torch.Tensor]] = [[] for _ in self.groups]
        loss_chunks: List[torch.Tensor] = []
        row_of = np.zeros(m, np.int64)
        offsets = [0] * len(self.groups)
        for grp in groups:
            gi = self._group_index[grp.program]
            with tel.span(
                "cohort_epoch", round=self._round, program=grp.program.name, clients=len(grp.members),
                epochs=grp.epochs, steps=grp.steps, batch=grp.batch,
            ) as sp:
                flat = starts_for(grp.members, gi)
                spec = self.packs[gi].spec
                for e in range(grp.epochs):
                    xb, yb = self.store.gather(grp.members, grp.idx[:, e])
                    if e == 0:
                        cost = tel.jit_cost(
                            "cohort_epoch_flat", _cohort_epoch_flat, flat, xb, yb, spec, grp.program, grp.steps, grp.lr
                        )
                        if cost:
                            sp.set(**cost)
                    flat, loss = _cohort_epoch_flat(flat, xb, yb, spec, grp.program, grp.steps, grp.lr)
            mats[gi].append(flat)
            loss_chunks.append(loss)
            row_of[grp.members] = np.arange(offsets[gi], offsets[gi] + len(grp.members))
            offsets[gi] += len(grp.members)
        for gi in range(len(self.groups)):  # empty shards upload their start row untouched
            pt = passthrough[self.group_of[passthrough] == gi]
            if len(pt):
                mats[gi].append(starts_for(pt, gi))
                loss_chunks.append(torch.zeros(len(pt), device=dev))
                row_of[pt] = np.arange(offsets[gi], offsets[gi] + len(pt))
                offsets[gi] += len(pt)
        compressing = self.compression is not None and self.compression.kind != "none"
        agg_mask = participating if failed is None else participating & ~failed
        for gi, prog in enumerate(self.groups):
            job_cids = np.nonzero(active & (self.group_of == gi))[0]
            if not len(job_cids):
                continue  # no member of this group trained this round
            upd_matrix = torch.cat(mats[gi], dim=0) if len(mats[gi]) > 1 else mats[gi][0]
            if compressing or prog.quantizes_upload:
                trained = upd_matrix[upload(row_of[job_cids], dev)]
                if compressing:
                    upd_matrix = self._compress_rows(job_cids, starts_for(job_cids, gi), trained, failed)
                else:
                    # the program's upload transform (FedSGD's fp16
                    # gradients): one batched op over the (C, D) rows
                    upd_matrix = prog.quantize_upload(starts_for(job_cids, gi), trained)
                row_of[job_cids] = np.arange(len(job_cids))
            # every edge's FedAvg of this group in ONE segment call
            with tel.span(
                "edge_aggregate", round=self._round, group=prog.name, clients=len(job_cids), edges=n,
            ) as sp:
                pc_g, pe_g, pe_g_dev = self._gpairs[gi]
                part_pairs = agg_mask[pc_g]
                take = row_of[pc_g]
                if len(take) == upd_matrix.shape[0] and np.array_equal(take, np.arange(len(take))):
                    upd = upd_matrix  # rows already in pair order: skip the gather
                else:
                    upd = upd_matrix[upload(take, dev)]
                # edges with no participant of this group keep its previous model
                has = np.bincount(pe_g, weights=part_pairs, minlength=n) > 0
                w = upload(self._data_sizes[pc_g] * part_pairs, dev)
                has_dev = upload(has, dev)
                cost = tel.jit_cost(
                    "segment_agg_keep", _segment_agg_keep, upd, pe_g_dev, w, has_dev, edge_mats[gi], n, self.backend
                )
                if cost:
                    sp.set(**cost)
                edge_mats[gi] = _segment_agg_keep(upd, pe_g_dev, w, has_dev, edge_mats[gi], n, self.backend)
                if self._edge_got is not None:
                    self._edge_got[gi] |= has
                    self._got_dev[gi] |= has_dev
        self._edge_account(participating, failed)
        return edge_mats, loss_chunks

    def _compress_rows(self, job_cids: np.ndarray, starts: torch.Tensor, trained: torch.Tensor, failed):
        """The participants' (C, D) uploads under the compression, in one
        batched call; a lost upload keeps its trained row (it weighs 0) and
        leaves its error feedback alone."""
        keep = np.ones(len(job_cids), bool) if failed is None else ~failed[job_cids]
        if keep.all():
            return compress_flat_rows(self.compression, self._errors, job_cids.tolist(), starts, trained)
        if not keep.any():
            return trained
        sel = upload(np.nonzero(keep)[0], self.device)
        rows = compress_flat_rows(self.compression, self._errors, job_cids[keep].tolist(), starts[sel], trained[sel])
        return trained.index_copy(0, sel, rows)

    def _edge_round_host(self, edge_rows: List[List[torch.Tensor]]) -> List[float]:
        """One edge round, host pipeline; updates ``edge_rows`` (per group,
        one (D_g,) row per edge) in place and returns the participants'
        losses.  One ``flat_mean`` per (group, edge) cell with uploads."""
        m, n = self.assignment.shape
        with self.tel.span("assignment", round=self._round, engine="sync-host"):
            participating, failed = self._draw_participation(m)
            # job prep consumes the RNG in client order, like the reference
            jobs, job_edges = [], []
            for i, cl in enumerate(self.clients):
                edges = np.nonzero(self.assignment[i])[0]
                if len(edges) == 0 or not participating[i]:
                    continue
                rows = edge_rows[self.group_of[i]]
                # a DCA client starts from the average of its edges' models
                start = rows[edges[0]] if len(edges) == 1 else flat_mean(
                    torch.stack([rows[j] for j in edges]), self._ones_dev[: len(edges)], backend=self.backend
                )
                jobs.append(make_job(cl, start, self.rng, epochs=self.schedule.local_steps))
                job_edges.append(edges)
        trained = run_cohorts(jobs, self.program, self.pack, impl="xla", telemetry=self.tel)
        compressing = self.compression is not None and self.compression.kind != "none"
        losses: List[float] = []
        uploads: Dict[tuple, List[int]] = {}
        rows: Dict[tuple, List[torch.Tensor]] = {}
        for job, edges in zip(jobs, job_edges):
            cid = job.client.cid
            gi = self.group_of[cid]
            losses.append(trained.loss[cid])
            if failed is not None and failed[cid]:
                continue  # trained, transmitted, lost: masked out of FedAvg
            prog = job.client.program
            transforming = compressing or prog.quantizes_upload
            if compressing:
                row = compress_flat_upload(self.compression, self._errors, cid, job.start_flat, trained.row(cid))
            elif transforming:
                row = prog.quantize_upload(job.start_flat, trained.row(cid))
            for j in edges:
                uploads.setdefault((j, gi), []).append(cid)
                if transforming:
                    rows.setdefault((j, gi), []).append(row)
        with self.tel.span("edge_aggregate", round=self._round, engine="sync-host", edges=len(uploads)):
            for (j, gi), cids in uploads.items():
                mat = torch.stack(rows[(j, gi)]) if (j, gi) in rows else trained.gather(cids)
                weights = torch.stack([self._sizes_dev[c] for c in cids])
                edge_rows[gi][j] = flat_mean(mat, weights, backend=self.backend)
                if self._edge_got is not None:
                    self._edge_got[gi][j] = True
                    self._got_dev[gi][j] = True
        self._edge_account(participating, failed)
        return losses

    def _kd_fuse_device(self, edge_mats: List[torch.Tensor]) -> List[torch.Tensor]:
        """Fuse every edge's group models on its public shard: the public
        batches are drawn from the engine RNG and gathered from the public
        store in one call."""
        n = self.assignment.shape[1]
        idx = draw_public_batches(self.rng, self.public_store.sizes, self.distill)
        xb = self.public_store.gather(np.arange(n), idx)[0]  # (E, steps, B, *feat)
        fused, _ = distill_fuse_flat(
            self.groups, [pk.spec for pk in self.packs], edge_mats, xb, self.distill, telemetry=self.tel
        )
        return fused

    def _kd_fuse_host(self, edge_rows: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
        """The host pipeline's fuse: the same flat fuse over stacked rows."""
        fused = self._kd_fuse_device([torch.stack(rows) for rows in edge_rows])
        return [list(mat.unbind(0)) for mat in fused]

    def _central_step(self) -> None:
        self.central_params = central_reference_step(
            self.central_params, self.central_data, self.rng, self.central_batch, self.program,
            device=self.device,
        )

    def _cloud_weights(self) -> List[torch.Tensor]:
        """The cloud FedAvg weights of each group on the device: uploaded
        once per run (and again after a reassignment), so that no cloud
        round's reduce waits on a host-to-device copy."""
        sizes = group_edge_sizes(self.clients, self.assignment, self.group_of)
        return [torch.as_tensor(w, device=self.device) for w in sizes]

    def _cloud_reduce(self, edge_mat: torch.Tensor, edge_sizes: torch.Tensor, global_row: torch.Tensor, g: int):
        """Group ``g``'s cloud FedAvg.  Under faults an edge that aggregated
        nothing of the group all cloud round weighs 0, through the group's
        device mask (no upload), and when every edge starved the group's
        global row stands (the host mask decides that)."""
        if self.faults is None:
            return self._cloud_mean(edge_mat, edge_sizes)
        if not self._edge_got[g].any():
            return global_row
        return self._cloud_mean(edge_mat, edge_sizes * self._got_dev[g])

    def run(self, cloud_rounds: int, eval_every: int = 1) -> SimResult:
        n = self.assignment.shape[1]
        n_groups = len(self.groups)
        history: List[RoundMetrics] = []
        global_rows = [pk.ravel(t) for pk, t in zip(self.packs, self.group_params)]
        edge_sizes = self._cloud_weights()
        cloud_bits = None if n_groups == 1 else float(sum(self._group_bits))
        engine_name = self.engine_name
        comm = CommDelta(self.accountant) if self.tel.enabled else None
        wall_accum = sim_accum = 0.0
        for b in range(1, cloud_rounds + 1):
            t_round = time.perf_counter()
            sim0 = self.clock.seconds if self.clock is not None else 0.0
            self._round = b
            acc = None
            with self.tel.span("cloud_round", round=b, engine=engine_name):
                if self.faults is not None:
                    if self._maybe_repair(b):
                        edge_sizes = self._cloud_weights()
                    self._edge_got = [np.zeros(n, bool) for _ in range(n_groups)]
                    self._got_dev = [torch.zeros(n, dtype=torch.bool, device=self.device) for _ in range(n_groups)]
                    if self.clock is not None:
                        # the straggler model reads the round's faded channel
                        self.clock.latency = self.faults.latency(b)
                chunks: List[torch.Tensor] = []
                losses: List[float] = []
                if self.pipeline == "device":
                    edge_mats = self._broadcast_rows(global_rows, n)
                    for k in range(self.schedule.edge_per_cloud):
                        self._er = k + 1
                        edge_mats, round_chunks = self._edge_round_device(edge_mats)
                        chunks += round_chunks
                    if self.distill is not None:
                        edge_mats = self._kd_fuse_device(edge_mats)
                else:
                    edge_rows = [[row] * n for row in global_rows]
                    for k in range(self.schedule.edge_per_cloud):
                        self._er = k + 1
                        losses += self._edge_round_host(edge_rows)
                    if self.distill is not None:
                        edge_rows = self._kd_fuse_host(edge_rows)
                # one cloud reduce per group, straight off its (E, D_g) matrix
                with self.tel.span("cloud_reduce", round=b, groups=n_groups, edges=n) as sp:
                    if self.pipeline == "device":
                        cost = self.tel.jit_cost("cloud_reduce", self._cloud_mean, edge_mats[0], edge_sizes[0])
                        if cost:
                            sp.set(**cost)
                    else:
                        edge_mats = [torch.stack(rows) for rows in edge_rows]
                    global_rows = [
                        self._momentum[g](
                            global_rows[g], self._cloud_reduce(edge_mats[g], edge_sizes[g], global_rows[g], g)
                        )
                        for g in range(n_groups)
                    ]
                if self.pipeline == "device":
                    loss_host = self._mean_loss(chunks)
                else:
                    loss_host = float(np.mean(losses)) if losses else 0.0
                self.accountant.on_cloud_sync(n, bits=cloud_bits)
                if self.clock is not None:
                    self.clock.on_cloud_sync()
                serve_rec = (
                    self.serve.on_round(b, lambda rows=global_rows: self.pack.unravel(rows[0]))
                    if self.serve is not None else {}
                )
                div = 0.0
                if self.track_divergence:
                    # drawn from the engine RNG after the cloud reduce, as the
                    # reference does
                    for _ in range(self.schedule.cloud_period):
                        self._central_step()
                    div = weight_divergence(self.pack.unravel(global_rows[0]), self.central_params)
                if b % eval_every == 0 or b == cloud_rounds:
                    with self.tel.span("eval", round=b) as sp:
                        acc = float(np.mean([
                            evaluate(self.packs[g].unravel(global_rows[g]), self.groups[g], self.test)
                            for g in range(n_groups)
                        ]))
                        sp.set(acc=acc)
            round_wall = time.perf_counter() - t_round
            round_sim = (self.clock.seconds - sim0) if self.clock is not None else 0.0
            wall_accum += round_wall
            sim_accum += round_sim
            if acc is not None:
                history.append(
                    RoundMetrics(b, acc, div, loss_host, wall_seconds=wall_accum, sim_seconds=sim_accum)
                )
                wall_accum = sim_accum = 0.0
            if self.tel.enabled:
                if acc is not None:
                    self.tel.metrics.set_gauge("eval_acc", acc)
                self.tel.on_round(
                    engine=engine_name, round=b, acc=acc, loss=loss_host if chunks or losses else None,
                    wall_s=round_wall, sim_s=round_sim if self.clock is not None else None, **serve_rec,
                    **comm.take(),
                )
        trees = [pk.unravel(row) for pk, row in zip(self.packs, global_rows)]
        self.params = trees[0] if n_groups == 1 else hetero_final_params(self.groups, trees)
        result = SimResult(
            history, self.accountant, self.params, telemetry=self.tel if self.tel.enabled else None,
            serve_history=self.serve.history if self.serve is not None else None,
        )
        if self.clock is not None:
            result.wall_seconds = self.clock.seconds
        return result


def _mean_loss(chunks: Sequence[torch.Tensor]) -> float:
    """Mean of the per-client losses, in float32 on the host as the
    reference takes it."""
    if not chunks:
        return 0.0
    return float(np.mean(np.concatenate([c.detach().cpu().numpy() for c in chunks])))
