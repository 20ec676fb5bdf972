"""Synchronous HFL over an edge mesh: ``k`` processes, one per edge rank.

The reference's ``MeshSyncEngine`` is one controller running
``shard_map`` programs over a 1-D ``"edge"`` device mesh.  The port is an
SPMD program: every rank of a ``torch.distributed.device_mesh.DeviceMesh``
built by ``repro_torch.distributed.axes.edge_mesh`` runs this engine's loop
on the same arguments, and the mapping is the reference's (paper eqs.
8-9):

  * rank ``r`` owns edges ``[r * E/k, (r + 1) * E/k)`` and only their EUs:
    its shard store holds only those clients' shards, and their cohort
    rows, edge starts, local epochs and the per-edge FedAvg stay on the
    rank, so the T edge rounds of a cloud round issue **no** collective;
  * the cloud FedAvg is the one collective that carries a model: each
    rank's ``flat_mean`` over its edge rows scaled by its share of the
    total edge weight (exactly 1.0 on one rank, so one rank is the device
    pipeline's ``_cloud_mean`` bit for bit), then one ``all_reduce`` over
    the edge group: one model payload per cloud round, 1/T of what a
    per-edge-round schedule moves;
  * the round's mean local loss needs every rank's client losses: one
    ``all_reduce`` of the round's loss vector (zero where another rank
    trained), in the device pipeline's cohort order, once per cloud round.

Every rank draws the whole round's participation and ``CohortPlan`` from
the same numpy stream, in global client order, and keeps its rows, so the
trajectory is the device pipeline's.  Unlike the reference, a rank's rows
are not padded to a power of two (``shard_map`` needs equal static blocks;
eager PyTorch does not): a rank keeps exactly its members in member order,
and its edge FedAvg is the device pipeline's one segment call restricted
to its membership pairs, on the segment kernel.  At one rank every kernel
call is the device pipeline's own; at more ranks the per-rank batched
epochs and the cloud reduce's association differ in rounding (the tests
hold them to 1e-6).

``MeshCommLedger`` counts the bytes of every tensor the engine hands to a
collective while each named program runs (there is no HLO to analyse);
``comm_report()`` returns them beside ``CommAccountant``'s simulated bits.
The engine issues ``all_reduce`` only, through the ledger: gloo reduces
CUDA tensors with it, so ``k`` ranks can share one card.

Scope (``ValueError`` otherwise): single-connectivity (SCA) assignments,
one architecture group, no compression, upload quantization or fault
injection, an edge count divisible by ``k``.  Every rank returns the same
``SimResult``; with ``k > 1`` only rank 0 writes a telemetry directory.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hfl import HFLSchedule
from repro_torch.device import resolve_device, upload
from repro_torch.distributed.axes import EDGE_AXIS, edge_mesh, mesh_rank, mesh_size
from repro_torch.engine.cohort import _cohort_epoch_flat
from repro_torch.engine.flatten import flat_mean, flat_segment_mean
from repro_torch.engine.store import DeviceShardStore
from repro_torch.engine.sync_sim import BatchedSyncEngine, _segment_agg_keep
from repro_torch.federated.programs import group_edge_sizes


class MeshCommLedger:
    """Collective bytes per mesh program.

    :meth:`call` runs program ``key`` and counts the bytes of every tensor
    handed to :meth:`all_reduce` while it runs; a program's first call
    with a new argument-shape signature counts as a compile, as the
    reference's cache key does.  Bytes are cross-edge when the group spans
    more than one edge rank."""

    def __init__(self, group=None, n_ranks: int = 1, telemetry=None):
        self.group = group
        self.n_ranks = n_ranks
        self.tel = telemetry
        self._stats: Dict[tuple, Dict[str, float]] = {}
        self._calls: Dict[tuple, int] = {}
        self._cross_total: Dict[tuple, float] = {}
        self._open = 0

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the edge group in place, counting its bytes
        against the program running."""
        self._open += tensor.numel() * tensor.element_size()
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def call(self, key: str, fn, *args):
        sig = (key, tuple((tuple(a.shape), str(a.dtype)) for a in args if isinstance(a, torch.Tensor)))
        self._open = 0
        out = fn(*args)
        coll = float(self._open)
        cross = coll if self.n_ranks > 1 else 0.0
        if sig not in self._stats and self.tel is not None and self.tel.enabled:
            self.tel.metrics.set_gauge(f"mesh_coll_bytes/{key}", coll)
            self.tel.metrics.set_gauge(f"mesh_cross_edge_bytes/{key}", cross)
        self._stats[sig] = {"coll_bytes": coll, "cross_edge_bytes": cross}
        self._calls[sig] = self._calls.get(sig, 0) + 1
        self._cross_total[sig] = self._cross_total.get(sig, 0.0) + cross
        return out

    def report(self) -> Dict[str, object]:
        programs: Dict[str, Dict[str, float]] = {}
        for sig, n in self._calls.items():
            rec = programs.setdefault(
                sig[0],
                {"calls": 0, "compiles": 0, "coll_bytes_per_call": 0.0,
                 "cross_edge_bytes_per_call": 0.0, "cross_edge_bytes_total": 0.0},
            )
            rec["calls"] += n
            rec["compiles"] += 1
            # per-call figures report the most recent signature's last call
            rec["coll_bytes_per_call"] = self._stats[sig]["coll_bytes"]
            rec["cross_edge_bytes_per_call"] = self._stats[sig]["cross_edge_bytes"]
            rec["cross_edge_bytes_total"] += self._cross_total[sig]
        return {
            "programs": programs,
            "cross_edge_total_bytes": sum(p["cross_edge_bytes_total"] for p in programs.values()),
        }


class MeshSyncEngine(BatchedSyncEngine):
    """``BatchedSyncEngine``'s device pipeline with the edges split over an
    edge mesh (see the module docstring).  ``mesh`` is a rank count, a
    ``DeviceMesh`` with an ``"edge"`` dimension, or None for the largest
    rank count of the default group that divides the edge count (one rank
    without a group).  ``device`` defaults to "cuda" (raising without CUDA
    unless "cpu")."""

    def __init__(
        self,
        clients,
        assignment,
        program,
        test,
        schedule: HFLSchedule = HFLSchedule(1, 1),
        seed: int = 0,
        upp: float = 1.0,
        track_divergence: bool = False,
        central_batch: int = 50,
        cost_latency=None,
        backend: str = "kernel",
        telemetry=None,
        cohort=None,
        server_momentum: float = 0.0,
        mesh=None,
        faults=None,
        compression=None,
        serve=None,
        device="cuda",
    ):
        if faults is not None:
            raise ValueError("MeshSyncEngine does not support fault injection")
        if compression is not None and getattr(compression, "kind", "none") != "none":
            raise ValueError("MeshSyncEngine does not support upload compression")
        dev = resolve_device(device)
        n = np.asarray(assignment).shape[1]
        if mesh is None:
            k = min(dist.get_world_size() if dist.is_initialized() else 1, n)
            while n % k:
                k -= 1
            mesh = edge_mesh(k, device=dev)
        elif isinstance(mesh, (int, np.integer)):
            mesh = edge_mesh(int(mesh), device=dev)
        elif EDGE_AXIS not in (getattr(mesh, "mesh_dim_names", None) or ()):
            raise ValueError(f"mesh must carry an {EDGE_AXIS!r} axis")
        self.mesh = mesh
        self.n_devices = mesh_size(mesh)
        if n % self.n_devices:
            raise ValueError(f"edge count {n} must be divisible by mesh size {self.n_devices}")
        self.rank = mesh_rank(mesh)
        self._epe = n // self.n_devices  # edges per rank
        self._lo = self.rank * self._epe
        self._ledger = MeshCommLedger(mesh.get_group(EDGE_AXIS), self.n_devices)
        self._edge_rounds_done = 0
        self._cloud_syncs_done = 0
        super().__init__(
            clients, assignment, program, test, schedule=schedule, seed=seed, upp=upp,
            track_divergence=track_divergence, central_batch=central_batch, cost_latency=cost_latency,
            backend=backend, pipeline="device", telemetry=telemetry, cohort=cohort,
            server_momentum=server_momentum, serve=serve, device=dev,
        )
        if len(self.groups) > 1:
            raise ValueError(
                "MeshSyncEngine supports one architecture group; use BatchedSyncEngine for model_mix populations"
            )
        if self.program.quantizes_upload:
            raise ValueError("MeshSyncEngine does not support upload quantization")
        if not self._single_edge:
            raise ValueError("MeshSyncEngine requires single-connectivity (SCA) assignments")
        # the rank's membership pairs (client-major), edge ids local to the rank
        on_rank = self._owned[self._pair_clients]
        self._rank_pair_clients = self._pair_clients[on_rank]
        self._rank_pair_edges = self._pair_edges[on_rank] - self._lo
        self._rank_pair_edges_dev = upload(self._rank_pair_edges, self.device)
        self._ledger.tel = self.tel
        if self.tel.enabled:
            self.tel.metrics.set_gauge("mesh_devices", self.n_devices)
            self.tel.metrics.set_gauge("mesh_edges_per_device", self._epe)
            if self.rank:
                self.tel.out_dir = None  # rank 0 writes the artifacts

    @property
    def engine_name(self) -> str:
        return "sync-mesh"

    # -- the rank's share of the state ---------------------------------------
    def _make_store(self, clients):
        """Only the rank's clients' shards, indexed by their position among
        the rank's clients (``self._local``)."""
        m = len(clients)
        self._owned = self._has_edge & (self._client_edge // self._epe == self.rank)
        own = np.nonzero(self._owned)[0]
        self._local = np.full(m, -1, np.int64)
        self._local[own] = np.arange(len(own))
        return DeviceShardStore.from_shards([clients[i].shard for i in own], self.device) if len(own) else None

    def _broadcast_rows(self, global_rows, n: int):
        return [row[None, :].expand(self._epe, -1) for row in global_rows]

    def _cloud_weights(self):
        """The rank's slice of the cloud weights, and its share of their
        total (the scale of its partial sum)."""
        sizes = group_edge_sizes(self.clients, self.assignment, self.group_of)[0]
        local = sizes[self._lo : self._lo + self._epe]
        self._share = 1.0 if self.n_devices == 1 else float(local.sum(dtype=np.float64) / sizes.sum(dtype=np.float64))
        return [torch.as_tensor(local, device=self.device)]

    def _cloud_partial(self, edge_mat: torch.Tensor, weights) -> torch.Tensor:
        part = flat_mean(edge_mat, weights, backend=self.backend)
        return part if self._share == 1.0 else part * self._share

    def _cloud_mean(self, edge_mat: torch.Tensor, weights) -> torch.Tensor:
        if edge_mat.is_meta:  # Telemetry.jit_cost counts the rank's part; the ledger has the collective
            return self._cloud_partial(edge_mat, weights)
        self._cloud_syncs_done += 1
        return self._ledger.call(
            "cloud_reduce", lambda mat, w: self._ledger.all_reduce(self._cloud_partial(mat, w)), edge_mat, weights
        )

    def _mean_loss(self, chunks) -> float:
        """Every rank's client losses of the cloud round, summed over the
        group in one ``all_reduce`` (each slot is written by one rank), then
        averaged as the device pipeline averages its chunks."""
        if not chunks:
            return 0.0
        vec = torch.cat(chunks)
        self._ledger.call("loss_gather", self._ledger.all_reduce, vec)
        return float(np.mean(vec.cpu().numpy()))

    # -- one edge round --------------------------------------------------------
    def _edge_round_device(self, edge_mats: List[torch.Tensor]):
        """One edge round on this rank: its members' cohorts, then its
        edges' FedAvg in one segment call; no collective.  Returns the
        rank's new (E/k, D) edge matrix and the round's loss vector in the
        device pipeline's cohort order (zero where another rank trained)."""
        m, n = self.assignment.shape
        dev, tel, lo, ledger = self.device, self.tel, self._lo, self._ledger
        with tel.span("assignment", round=self._round, engine="sync-mesh"):
            participating, _ = self._draw_participation(m)
            active = self._has_edge & participating
            groups, passthrough = self._plan.draw(self.rng, active, self.schedule.local_steps)
            if tel.enabled:
                tel.metrics.set_gauge("participating", int(active.sum()))

        def starts(ids: np.ndarray) -> torch.Tensor:
            idx = upload(self._client_edge[ids] - lo, dev)
            return ledger.call("edge_starts", lambda mat, i: mat[i], edge_mats[0], idx)

        rows: List[torch.Tensor] = []
        losses: List[torch.Tensor] = []
        slots: List[np.ndarray] = []  # each row's position in the round's loss vector
        row_of = np.zeros(m, np.int64)
        n_rows = pos = 0
        spec = self.packs[0].spec
        for grp in groups:
            mine = self._owned[grp.members]
            members = grp.members[mine]
            if len(members):
                with tel.span(
                    "cohort_epoch", round=self._round, engine="sync-mesh", program=grp.program.name,
                    clients=len(members), epochs=grp.epochs, steps=grp.steps, batch=grp.batch,
                ) as sp:
                    flat = starts(members)
                    idx = grp.idx[mine]

                    def epoch(f, xb, yb, g=grp):
                        return _cohort_epoch_flat(f, xb, yb, spec, g.program, g.steps, g.lr)

                    for e in range(grp.epochs):
                        xb, yb = self.store.gather(self._local[members], idx[:, e])
                        if e == 0:
                            cost = tel.jit_cost(
                                "cohort_epoch_flat", _cohort_epoch_flat, flat, xb, yb, spec, grp.program,
                                grp.steps, grp.lr,
                            )
                            if cost:
                                sp.set(**cost)
                        flat, loss = ledger.call("cohort_epoch", epoch, flat, xb, yb)
                rows.append(flat)
                losses.append(loss)
                slots.append(pos + np.nonzero(mine)[0])
                row_of[members] = np.arange(n_rows, n_rows + len(members))
                n_rows += len(members)
            pos += len(grp.members)
        mine = self._owned[passthrough]
        pt = passthrough[mine]
        if len(pt):  # empty shards upload their start row untouched
            rows.append(starts(pt))
            losses.append(torch.zeros(len(pt), device=dev))
            slots.append(pos + np.nonzero(mine)[0])
            row_of[pt] = np.arange(n_rows, n_rows + len(pt))
            n_rows += len(pt)
        pos += len(passthrough)
        if rows:
            upd = torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]
            pc = self._rank_pair_clients
            take = row_of[pc]
            if len(take) != upd.shape[0] or not np.array_equal(take, np.arange(len(take))):
                upd = upd[upload(take, dev)]
            part_pairs = participating[pc]
            has = np.bincount(self._rank_pair_edges, weights=part_pairs, minlength=self._epe) > 0
            w = upload(self._data_sizes[pc] * part_pairs, dev)
            has_dev = upload(has, dev)
            with tel.span(
                "edge_aggregate", round=self._round, engine="sync-mesh", clients=n_rows, edges=self._epe,
            ) as sp:
                seg = self._rank_pair_edges_dev
                cost = tel.jit_cost(
                    "segment_agg_keep", _segment_agg_keep, upd, seg, w, has_dev, edge_mats[0], self._epe, self.backend
                )
                if cost:
                    sp.set(**cost)
                edge_mats[0] = ledger.call(
                    "edge_agg",
                    lambda u, s, ww, h, prev: _segment_agg_keep(u, s, ww, h, prev, self._epe, self.backend),
                    upd, seg, w, has_dev, edge_mats[0],
                )
        self._edge_rounds_done += 1
        self._edge_account(participating, None)
        if not pos:
            return edge_mats, []
        vec = torch.zeros(pos, device=dev)
        if losses:
            vec[upload(np.concatenate(slots), dev)] = torch.cat(losses)
        return edge_mats, [vec]

    # -- reporting -------------------------------------------------------------
    def comm_report(self) -> Dict[str, object]:
        """The ledger's collective bytes beside the simulated accounting:
        ``cross_edge_bytes_per_cloud_round`` is about one model payload (the
        cloud ``all_reduce``) and the edge programs' bytes are zero."""
        rep = self._ledger.report()
        row_bytes = torch.empty((), dtype=self.pack.spec.dtypes[0]).element_size()
        rep.update(
            devices=self.n_devices,
            edges=int(self.assignment.shape[1]),
            edges_per_device=self._epe,
            payload_bytes=row_bytes * int(self.pack.dim),
            edge_rounds=self._edge_rounds_done,
            cloud_syncs=self._cloud_syncs_done,
            cross_edge_bytes_per_cloud_round=rep["cross_edge_total_bytes"] / max(1, self._cloud_syncs_done),
            cross_edge_bytes_per_edge_round=rep["cross_edge_total_bytes"] / max(1, self._edge_rounds_done),
            simulated=self.accountant.totals(),
        )
        return rep


def mesh_segment_mean(mesh, updates, seg_ids, weights, n_segments: int) -> np.ndarray:
    """Per-segment weighted mean over an edge mesh: the mesh engine's edge
    FedAvg as a standalone function.  Every rank passes the same (N, D)
    rows (any order, ragged over segments); rank ``r`` averages the rows of
    its segments ``[r * S/k, (r + 1) * S/k)`` through the segment kernel,
    with no collective, and the full (S, D) result is assembled on every
    rank by one ``all_reduce`` of the zero-padded blocks.  Empty segments
    give zero rows, as ``flat_segment_mean``."""
    upd = np.asarray(updates, np.float32)
    seg = np.asarray(seg_ids, np.int64)
    w = np.asarray(weights, np.float32)
    k = mesh_size(mesh)
    if n_segments % k:
        raise ValueError(f"n_segments {n_segments} must divide by mesh size {k}")
    epe = n_segments // k
    lo = mesh_rank(mesh) * epe
    dev = torch.device(mesh.device_type)
    full = torch.zeros((n_segments, upd.shape[1]), dtype=torch.float32, device=dev)
    sel = (seg >= lo) & (seg < lo + epe)
    if sel.any():
        full[lo : lo + epe] = flat_segment_mean(
            torch.as_tensor(upd[sel], device=dev), torch.as_tensor(seg[sel] - lo, device=dev),
            torch.as_tensor(w[sel], device=dev), epe,
        )
    if k > 1:
        dist.all_reduce(full, group=mesh.get_group(EDGE_AXIS))
    return full.cpu().numpy()
