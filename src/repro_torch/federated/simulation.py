"""Synchronous hierarchical FL, the readable simulator (the paper's Sec. 6).

``HFLSimulation`` drives M clients, N edges and the cloud through the
two-level schedule one client at a time: each client trains its own
parameter tree (``FLClient.local_update``), each edge averages its uploads
(``core.hfl.edge_aggregate``, eq. 6) and the cloud averages the edges
(``cloud_aggregate``, eq. 8-9).  It tracks accuracy per cloud round, the
weight divergence to a virtual centralized model (eq. 17) and the traffic
(``CommAccountant``): the raw material of paper Figs. 3-6.  It is the
port's own oracle: the batched engine is held to it.

Its FedAvg is plain PyTorch on whatever device the parameters live on
(the reference's is a ``jnp`` contraction, not a Pallas kernel), so no
CUDA kernel launches under it.  ``centralized_baseline`` is the paper's
benchmark with every shard pooled at one server.

``HeteroHFLSimulation`` is its counterpart for heterogeneous-model
populations (clients of more than one program): per-architecture FedAvg at
the edges and the cloud, and once per cloud round each edge's group models
fused by ensemble distillation on its public shard (``engine.distill``).

Also here: the round metrics and run results every engine returns, and
``evaluate``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.hfl import (
    CommAccountant,
    HFLSchedule,
    ServerMomentum,
    WallClock,
    cloud_aggregate,
    edge_aggregate,
    weight_divergence,
)
from repro_torch.data.synthetic_health import Dataset
from repro_torch.device import configure_numerics, resolve_device
from repro_torch.federated.client import FLClient, _local_epoch
from repro_torch.federated.programs import as_program, group_clients, group_edge_sizes
from repro_torch.telemetry import NULL_TELEMETRY, coerce_telemetry
from repro_torch.telemetry.report import CommDelta
from repro_torch.utils.tree import tree_add, tree_leaves, tree_map, tree_size_bytes, tree_sub

def check_cohort(cohort, upp: float) -> None:
    """A cohort and UPP are both participation models: a ``CohortSpec``
    runs with ``upp=1.0`` only (``ValueError`` otherwise), as in the
    reference."""
    if cohort is not None and upp != 1.0:
        raise ValueError("cohort sampling and UPP are both participation models; use upp=1.0 with a CohortSpec")


@dataclasses.dataclass
class RoundMetrics:
    cloud_round: int
    test_acc: float
    divergence: float
    mean_local_loss: float
    # host seconds since the previous history entry, and the simulated
    # seconds of the same rounds when the run models latency (WallClock)
    wall_seconds: float = 0.0
    sim_seconds: float = 0.0


@dataclasses.dataclass
class SimResult:
    history: List[RoundMetrics]
    accountant: CommAccountant
    final_params: dict
    wall_seconds: float = 0.0
    # the run's Telemetry (None when telemetry was off): ``.summary()`` is
    # the end-of-run table, ``.rounds`` the per-round records
    telemetry: object = None
    # one serve record per cloud round (round, queries, serve_qps,
    # serve_staleness_rounds, serve_acc) when the run carried query traffic
    # (``Scenario.simulate(serve=TrafficSpec(...))``), else None
    serve_history: Optional[List[dict]] = None
    # the mesh engine's collective bytes beside its simulated accounting
    # (``MeshSyncEngine.comm_report()``) when the run went over an edge mesh
    comm_report: Optional[dict] = None

    def rounds_to_accuracy(self, target: float) -> Optional[int]:
        for m in self.history:
            if m.test_acc >= target:
                return m.cloud_round
        return None

    def final_accuracy(self) -> float:
        return self.history[-1].test_acc if self.history else 0.0


def pooled_dataset(clients: List[FLClient], n_classes: int) -> Dataset:
    """Every client's shard in one dataset, in client order."""
    return Dataset(
        np.concatenate([c.shard.x for c in clients], 0),
        np.concatenate([c.shard.y for c in clients], 0),
        n_classes,
    )


def central_reference_step(
    params, data: Dataset, rng: np.random.Generator, batch: int, program, device="cuda"
):
    """One mini-epoch of the virtual centralized model (divergence
    reference, eq. 17) on ``device`` ("cuda" by default, raising without
    CUDA unless "cpu"); returns its parameters there.

    ``steps = max(1, min(128, n // batch))``: a floor with no padding,
    unlike the clients' epochs.  Shared by the readable simulator and the
    batched engine, so the two baselines cannot drift apart.
    """
    device = resolve_device(device)
    configure_numerics(device)
    program = as_program(program)
    params = tree_map(lambda t: t.to(device), params)
    n = len(data)
    steps = max(1, min(128, n // batch))
    idx = rng.permutation(n)[: steps * batch].reshape(steps, batch)
    xb = torch.as_tensor(data.x[idx], device=device)
    yb = torch.as_tensor(data.y[idx], device=device)
    params, _ = _local_epoch(params, xb, yb, program, steps, 1e-3)
    return params


@torch.no_grad()
def evaluate(params, program, test: Dataset, batch: int = 512) -> float:
    """Weighted mean of ``program.metric`` over the test set, in batches on
    the parameters' device."""
    program = as_program(program)
    device = tree_leaves(params)[0].device
    accs, ns = [], []
    for i in range(0, len(test), batch):
        x = torch.as_tensor(test.x[i : i + batch], device=device)
        y = torch.as_tensor(test.y[i : i + batch], device=device)
        accs.append(float(program.metric(params, x, y)) * len(y))
        ns.append(len(y))
    return float(np.sum(accs) / np.sum(ns))


def initial_params(program, seed: int, device: torch.device) -> dict:
    """``program.init`` from a ``torch.Generator`` seeded with ``seed``,
    drawn on the CPU (so the card and the CPU start from one model) and
    moved to ``device``.  Every engine of the port starts here."""
    params = program.init(torch.Generator().manual_seed(seed))
    return tree_map(lambda t: t.to(device), params)


class HFLSimulation:
    """The readable synchronous simulator over one client program.

    ``assignment`` is the (M, N) binary matrix (dual-connectivity rows
    allowed).  UPP participation (``upp``), DCA starts, per-edge and cloud
    FedAvg, ``CommAccountant``, a ``WallClock`` when ``cost_latency`` is
    given, and ``track_divergence``.  ``compression`` (a
    ``CompressionSpec``) compresses each upload per leaf with per-EU error
    feedback and charges ``compression.bits(params)``; it takes precedence
    over the program's own upload quantization.  ``faults`` (a
    ``FaultState``) masks churned-out and battery-dead EUs out of a round,
    drops the uploads ``failed_uploads`` marks (charged as wasted), debits
    energy, re-repairs the assignment under drift and weighs starved edges
    0 in the cloud reduce.  ``cohort`` (a ``CohortSpec``, with ``upp=1.0``)
    trains only the spec's sampled members each edge round, drawn from its
    keyed side channel in place of the UPP draw (the engine RNG is not
    consumed).  ``server_momentum`` applies cloud momentum to the
    aggregated delta (``core.hfl.ServerMomentum``).  ``telemetry`` (True,
    a directory or a ``Telemetry``) records the reference's spans
    (``assignment``, ``local_train``, ``edge_aggregate``, ``cloud_reduce``,
    ``eval``, ``cloud_round``), its fault counters and one record per cloud
    round.  ``serve`` (a ``serving.traffic.ServeTraffic``) drives one round
    of query traffic against the global model after each cloud reduce; it
    reads the model and draws from its own generator, so the run trains as
    without it.  ``device``: "cuda" by default, raising without CUDA unless
    "cpu".
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
        compression=None,
        faults=None,
        telemetry=None,
        cohort=None,
        server_momentum: float = 0.0,
        serve=None,
        device="cuda",
    ):
        check_cohort(cohort, upp)
        self.device = resolve_device(device)
        configure_numerics(self.device)
        self.clients = clients
        self.assignment = np.asarray(assignment)
        self.program = as_program(program)
        self.test = test
        self.schedule = schedule
        self.rng = np.random.default_rng(seed)
        self.upp = upp
        self.cohort = cohort
        self.serve = serve
        self._momentum = ServerMomentum(server_momentum)
        self.tel = coerce_telemetry(telemetry) or NULL_TELEMETRY
        self.params = initial_params(self.program, seed, self.device)
        self.track_divergence = track_divergence
        if track_divergence:
            self.central_params = self.params
            self.central_data = pooled_dataset(clients, self.program.n_classes)
            self.central_batch = central_batch
        model_bits = tree_size_bytes(self.params) * 8
        self.accountant = CommAccountant(model_bits=model_bits)
        self.clock = WallClock(cost_latency) if cost_latency is not None else None
        self.compression = compression
        self._comp_errors: dict = {}
        if compression is not None and compression.kind != "none":
            self._uplink_bits = compression.bits(self.params)
        else:
            # the program's uplink payload (FedSGD gradients; else the model)
            self._uplink_bits = self.program.uplink_bits(model_bits)
        self.faults = faults
        self._round = 0
        self._er = 0  # edge round within the current cloud round
        self._edge_got = None  # (N,) edges that received an upload this cloud round

    def _compress_upload(self, cid: int, start, trained):
        """The spec on the EU's model delta, per leaf, with per-EU error
        feedback; with no spec, the program's own upload transform (FedSGD's
        fp16 gradients; the identity otherwise)."""
        if self.compression is None or self.compression.kind == "none":
            return self.program.quantize_upload(start, trained)
        sparse, err = self.compression.apply(tree_sub(trained, start), self._comp_errors.get(cid))
        self._comp_errors[cid] = err
        return tree_add(start, sparse)

    def _edge_round(self, edge_params: List[dict]) -> List[float]:
        """One edge round: participation draw, every participant's local
        update in client order, then each edge's FedAvg of its uploads."""
        m, n = self.assignment.shape
        with self.tel.span("assignment", round=self._round, engine="reference"):
            if self.cohort is not None:
                participating = self.cohort.mask(self._round, self._er, assignment=self.assignment)
            else:
                participating = self.rng.random(m) < self.upp
                if not participating.any():
                    participating[self.rng.integers(0, m)] = True
        failed = None
        if self.faults is not None:
            # churned-out and battery-dead EUs sit the round out; of the
            # rest, the EUs ``failed_uploads`` marks train but lose their
            # (single, no-retry) upload.  Keyed fault streams only: the
            # engine RNG above is untouched.
            participating &= self.faults.participation(self._round)
            failed = (
                self.faults.failed_uploads(self._round, self._er) & participating & self.assignment.any(axis=1)
            )
            if self.tel.enabled:
                self.tel.metrics.inc("faults_dropped", int(failed.sum()))
        losses = []
        new_models: List[List[dict]] = [[] for _ in range(n)]
        new_sizes: List[List[float]] = [[] for _ in range(n)]
        with self.tel.span("local_train", round=self._round, clients=int(participating.sum())):
            for i, cl in enumerate(self.clients):
                edges = np.nonzero(self.assignment[i])[0]
                if len(edges) == 0 or not participating[i]:
                    continue
                # a DCA client starts from the average of its edges' models
                start = edge_params[edges[0]] if len(edges) == 1 else edge_aggregate(
                    [edge_params[j] for j in edges], [1.0] * len(edges)
                )
                upd, loss = cl.local_update(start, self.rng, epochs=self.schedule.local_steps)
                losses.append(loss)
                if failed is not None and failed[i]:
                    continue  # trained, transmitted, lost: no edge averages it
                upd = self._compress_upload(cl.cid, start, upd)
                for j in edges:
                    new_models[j].append(upd)
                    new_sizes[j].append(cl.data_size)
        with self.tel.span("edge_aggregate", round=self._round, edges=n):
            for j in range(n):
                if new_models[j]:
                    edge_params[j] = edge_aggregate(new_models[j], new_sizes[j])
                    if self._edge_got is not None:
                        self._edge_got[j] = True
        success = participating if failed is None else participating & ~failed
        self.accountant.on_edge_sync(self.assignment * success[:, None], uplink_bits=self._uplink_bits)
        if self.faults is not None:
            mc = self.accountant.dca_multicast_overhead
            for i in np.nonzero(failed)[0]:
                k = int(np.count_nonzero(self.assignment[i]))
                if k:
                    self.accountant.on_wasted_upload(
                        int(i), self._uplink_bits * (1.0 + (mc if k > 1 else 0.0)), kind="dropped"
                    )
            self.faults.debit_round(self._round, participating, self.assignment)
            self.faults.record_gauges(self.tel)
        if self.clock is not None:
            self.clock.on_edge_sync(self.assignment, participating)
        return losses

    def _central_step(self) -> None:
        self.central_params = central_reference_step(
            self.central_params, self.central_data, self.rng, self.central_batch, self.program,
            device=self.device,
        )

    def _edge_data_sizes(self) -> List[float]:
        return [
            sum(c.data_size for i, c in enumerate(self.clients) if self.assignment[i, j])
            for j in range(self.assignment.shape[1])
        ]

    def _maybe_repair(self, b: int) -> None:
        """Re-repair the assignment when channel drift invalidated
        memberships."""
        if not self.faults.spec.reassign:
            return
        new_lam, changed = self.faults.repair(b, self.assignment)
        if len(changed):
            self.assignment = new_lam
            if self.tel.enabled:
                self.tel.metrics.inc("faults_reassigned", int(len(changed)))

    def run(self, cloud_rounds: int, eval_every: int = 1) -> SimResult:
        n = self.assignment.shape[1]
        history: List[RoundMetrics] = []
        global_params = self.params
        edge_sizes = self._edge_data_sizes()
        comm = CommDelta(self.accountant) if self.tel.enabled else None
        wall_accum = sim_accum = 0.0
        for b in range(1, cloud_rounds + 1):
            t_round = time.perf_counter()
            sim0 = self.clock.seconds if self.clock is not None else 0.0
            self._round = b
            acc = None
            with self.tel.span("cloud_round", round=b, engine="reference"):
                if self.faults is not None:
                    self._maybe_repair(b)
                    if self.faults.spec.reassign:
                        edge_sizes = self._edge_data_sizes()
                    self._edge_got = np.zeros(n, bool)
                    if self.clock is not None:
                        # the straggler model reads the round's faded channel
                        self.clock.latency = self.faults.latency(b)
                edge_params = [global_params] * n
                losses: List[float] = []
                for k in range(self.schedule.edge_per_cloud):
                    self._er = k + 1
                    losses += self._edge_round(edge_params)
                with self.tel.span("cloud_reduce", round=b, edges=n):
                    if self.faults is not None:
                        # degraded reduce: an edge that received no upload
                        # all cloud round holds the stale global model and
                        # weighs 0; when every edge starved, the global
                        # model stands
                        w = [s if self._edge_got[j] else 0.0 for j, s in enumerate(edge_sizes)]
                        if any(w):
                            global_params = self._momentum(global_params, cloud_aggregate(edge_params, w))
                    else:
                        global_params = self._momentum(
                            global_params, cloud_aggregate(edge_params, [max(s, 1) for s in edge_sizes])
                        )
                self.accountant.on_cloud_sync(n)
                if self.clock is not None:
                    self.clock.on_cloud_sync()
                serve_rec = self.serve.on_round(b, lambda gp=global_params: gp) if self.serve is not None else {}
                div = 0.0
                if self.track_divergence:
                    for _ in range(self.schedule.cloud_period):
                        self._central_step()
                    div = weight_divergence(global_params, self.central_params)
                if b % eval_every == 0 or b == cloud_rounds:
                    with self.tel.span("eval", round=b) as sp:
                        acc = evaluate(global_params, self.program, self.test)
                        sp.set(acc=acc)
            round_wall = time.perf_counter() - t_round
            round_sim = (self.clock.seconds - sim0) if self.clock is not None else 0.0
            wall_accum += round_wall
            sim_accum += round_sim
            loss = float(np.mean(losses)) if losses else 0.0
            if acc is not None:
                history.append(RoundMetrics(b, acc, div, loss, wall_seconds=wall_accum, sim_seconds=sim_accum))
                wall_accum = sim_accum = 0.0
            if self.tel.enabled:
                if acc is not None:
                    self.tel.metrics.set_gauge("eval_acc", acc)
                self.tel.on_round(
                    engine="reference", round=b, acc=acc, loss=loss, wall_s=round_wall,
                    sim_s=round_sim if self.clock is not None else None, **serve_rec, **comm.take(),
                )
        self.params = global_params
        result = SimResult(
            history, self.accountant, global_params, telemetry=self.tel if self.tel.enabled else None,
            serve_history=self.serve.history if self.serve is not None else None,
        )
        if self.clock is not None:
            result.wall_seconds = self.clock.seconds
        return result


def hetero_final_params(programs, trees) -> Dict[str, dict]:
    """One final parameter tree per architecture group, keyed by program
    name; two groups that share a name (one architecture, two configs) get
    a positional ``#g`` suffix, so no tree is dropped."""
    out: Dict[str, dict] = {}
    for g, (prog, tree) in enumerate(zip(programs, trees)):
        out[prog.name if prog.name not in out else f"{prog.name}#{g}"] = tree
    return out


class HeteroHFLSimulation:
    """The readable simulator for heterogeneous-MODEL hierarchical FL.

    Clients may carry different programs: the population splits into
    architecture groups (``group_clients``) and the two-level schedule runs
    per group (per-edge FedAvg within each architecture, one cloud reduce
    per group), with one stage the homogeneous simulator lacks: once per
    cloud round, after the edge rounds and before the cloud reduce, each
    edge fuses its G group models by ensemble logit distillation on its own
    public shard (``engine.distill.distill_edge``).

    It is the oracle of the engines' group-aware paths: it consumes the
    numpy RNG stream in their order (the participation draw, each
    participant's batch draws in client order, then the public batches per
    edge in edge order), trains every client through ``local_update`` and
    charges the accountant with the same per-group calls (each EU pays its
    group's uplink and downlink; the round counts once; the cloud sync
    carries the sum of the group bits).

    ``public`` is one ``Dataset`` per edge; ``distill`` a ``DistillSpec``,
    or None for groups that evolve apart (still a valid federation).
    ``compression`` compresses each upload per leaf with per-EU error
    feedback.  Every group starts from ``program.init`` with a generator
    seeded from ``seed``.  ``telemetry`` records the reference's spans
    (``assignment``, ``local_train``, ``edge_aggregate``, ``kd_fuse``,
    ``cloud_reduce``, ``eval``, ``cloud_round``), ``kd_loss`` and one record
    per cloud round; ``device`` is "cuda" by default, raising without CUDA
    unless "cpu".
    """

    def __init__(
        self,
        clients: List[FLClient],
        assignment: np.ndarray,
        test: Dataset,
        schedule: HFLSchedule = HFLSchedule(1, 1),
        seed: int = 0,
        upp: float = 1.0,
        public: Optional[List[Dataset]] = None,
        distill=None,
        compression=None,
        telemetry=None,
        device="cuda",
    ):
        from repro_torch.engine.distill import check_distillable, check_public_shards

        self.device = resolve_device(device)
        configure_numerics(self.device)
        self.clients = clients
        self.assignment = np.asarray(assignment)
        self.test = test
        self.schedule = schedule
        self.rng = np.random.default_rng(seed)
        self.upp = upp
        self.tel = coerce_telemetry(telemetry) or NULL_TELEMETRY
        self._round = 0
        self.programs, self.group_of = group_clients(clients)
        self.group_params = [initial_params(p, seed, self.device) for p in self.programs]
        self._group_bits = [tree_size_bytes(t) * 8 for t in self.group_params]
        self.distill = distill if len(self.programs) > 1 else None
        self.public = public
        if self.distill is not None:
            check_public_shards(public, self.assignment.shape[1])
            check_distillable(self.programs)
        self.accountant = CommAccountant(model_bits=self._group_bits[0])
        self.compression = compression
        self._comp_errors: dict = {}
        if compression is not None and compression.kind != "none":
            self._uplink_bits = [compression.bits(t) for t in self.group_params]
        else:
            self._uplink_bits = [p.uplink_bits(b) for p, b in zip(self.programs, self._group_bits)]

    def _compress_upload(self, cid: int, start, trained):
        if self.compression is None or self.compression.kind == "none":
            return self.clients[cid].program.quantize_upload(start, trained)
        sparse, err = self.compression.apply(tree_sub(trained, start), self._comp_errors.get(cid))
        self._comp_errors[cid] = err
        return tree_add(start, sparse)

    def _edge_round(self, edge_params: List[List[dict]]) -> List[float]:
        """One edge round; ``edge_params[g][j]`` is edge j's group-g model."""
        m, n = self.assignment.shape
        with self.tel.span("assignment", round=self._round, engine="reference-hetero"):
            participating = self.rng.random(m) < self.upp
            if not participating.any():
                participating[self.rng.integers(0, m)] = True
        losses = []
        new_models: Dict[tuple, List[dict]] = {}
        new_sizes: Dict[tuple, List[float]] = {}
        with self.tel.span("local_train", round=self._round, clients=int(participating.sum())):
            for i, cl in enumerate(self.clients):
                edges = np.nonzero(self.assignment[i])[0]
                if len(edges) == 0 or not participating[i]:
                    continue
                g = int(self.group_of[i])
                rows = edge_params[g]
                start = rows[edges[0]] if len(edges) == 1 else edge_aggregate(
                    [rows[j] for j in edges], [1.0] * len(edges)
                )
                upd, loss = cl.local_update(start, self.rng, epochs=self.schedule.local_steps)
                losses.append(loss)
                upd = self._compress_upload(cl.cid, start, upd)
                for j in edges:
                    new_models.setdefault((g, j), []).append(upd)
                    new_sizes.setdefault((g, j), []).append(cl.data_size)
        with self.tel.span("edge_aggregate", round=self._round, edges=n):
            for (g, j), models in new_models.items():
                edge_params[g][j] = edge_aggregate(models, new_sizes[(g, j)])
        for g in range(len(self.programs)):
            mask = (self.group_of == g) & participating
            self.accountant.on_edge_sync(
                self.assignment * mask[:, None],
                uplink_bits=self._uplink_bits[g],
                downlink_bits=None if len(self.programs) == 1 else self._group_bits[g],
                count_round=(g == 0),
            )
        return losses

    def _kd_fuse(self, edge_params: List[List[dict]]) -> List[List[dict]]:
        from repro_torch.engine.distill import distill_edge, draw_public_batches

        n = self.assignment.shape[1]
        with self.tel.span("kd_fuse", round=self._round, edges=n, groups=len(self.programs)):
            idx = draw_public_batches(self.rng, [len(s) for s in self.public], self.distill)
            for j in range(n):
                fused, kd_losses = distill_edge(
                    self.programs, [rows[j] for rows in edge_params], self.public[j].x[idx[j]], self.distill
                )
                if self.tel.enabled:
                    for loss in kd_losses:
                        self.tel.metrics.observe("kd_loss", loss)
                for g, tree in enumerate(fused):
                    edge_params[g][j] = tree
        return edge_params

    def run(self, cloud_rounds: int, eval_every: int = 1) -> SimResult:
        n = self.assignment.shape[1]
        n_groups = len(self.programs)
        history: List[RoundMetrics] = []
        group_params = self.group_params
        edge_sizes = group_edge_sizes(self.clients, self.assignment, self.group_of)
        cloud_bits = None if n_groups == 1 else float(sum(self._group_bits))
        comm = CommDelta(self.accountant) if self.tel.enabled else None
        wall_accum = 0.0
        for b in range(1, cloud_rounds + 1):
            t_round = time.perf_counter()
            self._round = b
            acc = None
            with self.tel.span("cloud_round", round=b, engine="reference-hetero"):
                edge_params = [[tree] * n for tree in group_params]
                losses: List[float] = []
                for _ in range(self.schedule.edge_per_cloud):
                    losses += self._edge_round(edge_params)
                if self.distill is not None:
                    edge_params = self._kd_fuse(edge_params)
                with self.tel.span("cloud_reduce", round=b, groups=n_groups):
                    group_params = [cloud_aggregate(edge_params[g], edge_sizes[g]) for g in range(n_groups)]
                self.accountant.on_cloud_sync(n, bits=cloud_bits)
                if b % eval_every == 0 or b == cloud_rounds:
                    with self.tel.span("eval", round=b) as sp:
                        acc = float(np.mean([
                            evaluate(group_params[g], self.programs[g], self.test) for g in range(n_groups)
                        ]))
                        sp.set(acc=acc)
            round_wall = time.perf_counter() - t_round
            wall_accum += round_wall
            loss = float(np.mean(losses)) if losses else 0.0
            if acc is not None:
                history.append(RoundMetrics(b, acc, 0.0, loss, wall_seconds=wall_accum))
                wall_accum = 0.0
            if self.tel.enabled:
                if acc is not None:
                    self.tel.metrics.set_gauge("eval_acc", acc)
                self.tel.on_round(
                    engine="reference-hetero", round=b, acc=acc, loss=loss, wall_s=round_wall, sim_s=None,
                    **comm.take(),
                )
        self.group_params = group_params
        final = group_params[0] if n_groups == 1 else hetero_final_params(self.programs, group_params)
        return SimResult(history, self.accountant, final, telemetry=self.tel if self.tel.enabled else None)


def centralized_baseline(
    clients: List[FLClient],
    program,
    test: Dataset,
    rounds: int,
    batch: int = 50,
    seed: int = 0,
    eval_every: int = 1,
    device="cuda",
) -> List[RoundMetrics]:
    """The paper's benchmark: all data pooled at one server (batch 50/30),
    one mini-epoch of at most 128 steps per round."""
    dev = resolve_device(device)
    configure_numerics(dev)
    program = as_program(program)
    rng = np.random.default_rng(seed)
    data = pooled_dataset(clients, program.n_classes)
    params = initial_params(program, seed, dev)
    history = []
    n = len(data)
    wall_accum = 0.0
    for r in range(1, rounds + 1):
        t_round = time.perf_counter()
        steps = max(1, min(128, n // batch))
        idx = rng.permutation(n)[: steps * batch].reshape(steps, batch)
        xb = torch.as_tensor(data.x[idx], device=dev)
        yb = torch.as_tensor(data.y[idx], device=dev)
        params, loss = _local_epoch(params, xb, yb, program, steps, 1e-3)
        if r % eval_every == 0 or r == rounds:
            acc = evaluate(params, program, test)
            wall_accum += time.perf_counter() - t_round
            history.append(RoundMetrics(r, acc, 0.0, float(loss), wall_seconds=wall_accum))
            wall_accum = 0.0
        else:
            wall_accum += time.perf_counter() - t_round
    return history
