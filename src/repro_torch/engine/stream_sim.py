"""Streaming synchronous engine: the population M as a streaming axis.

``BatchedSyncEngine`` materializes the population (M ``FLClient``s, an
(M, N) assignment matrix, every shard on the device), which caps it near
M = 2048.  ``StreamSyncEngine`` keeps O(M) state only as small host arrays
(the source's (M,) shard sizes and the (M,) ``edge_of`` assignment) and
everything else at O(cohort):

  * clients come from a lazy ``ShardSource`` (``shard(cid)`` pure in
    ``(seed, cid)``), paged onto the device through a bounded
    ``PagedShardStore``;
  * each edge round trains only a ``CohortSpec`` cohort;
  * the round's trained rows go into one (C, D) matrix, and every edge's
    FedAvg over its sampled members is ONE ``_segment_agg_keep`` call (one
    ``hier_segment_aggregate`` launch on the card); an edge with no sampled
    member keeps its model, and one whose sampled members all weigh 0 gets
    a zero row;
  * the cloud reduce is one ``flat_mean`` (``hier_aggregate``) over the
    (E, D) edge matrix, with the edge sizes on the device once per run;
  * the accountant is charged with a compact (cohort, N) matrix carrying
    the true client ids (``row_ids``).

The reference pads every step-bucket group to one row count and sums each
group on its own, because under ``jit`` concatenating the groups would
compile a new shape every round.  Eager PyTorch keeps no such cache, so
the port trains only real rows and sums them in one call: the same weighted
mean in another summation order (parameters within 1e-4 of the
reference's).

Inside a round the host never waits for the card: member ids, segment ids,
weights, slots and batch indices are host numpy, uploaded asynchronously
from pinned memory, and the losses stay on the device until the round ends.

Scope, as in the reference: single connectivity (a compact ``edge_of``;
dual connectivity needs O(M*N) pairs), one program, no compression or
faults.  RNG: the cohort comes from the spec's keyed side channel, and the
batch indices consume the engine RNG per member in ascending client id,
draw for draw what ``BatchedSyncEngine(cohort=...)`` consumes for the same
members, so the two engines train on the same batches.

``telemetry`` records the reference's spans (``cloud_round``,
``assignment``, ``cohort_epoch`` per step-bucket group, ``edge_aggregate``,
``cloud_reduce``, ``eval``), the ``participating`` gauge and the paged
store's ``page_hits``, ``page_misses`` and ``page_evictions``, in the
reference's order.  Three spans are the port's own: ``cohort_draw``
(``CohortSpec.draw``) and ``batch_plan`` (``StreamCohortPlan.draw``)
inside ``assignment``, and ``page_in`` inside ``cloud_round``: the round's
paging, one batched write of the misses and the slots' upload before the
first group, where the reference pages each group inside its
``cohort_epoch``.  Under a recording ``torch.profiler`` each span is a
``tel:`` range too, which puts the card's idle time of a round down to
them.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.hfl import CommAccountant, HFLSchedule, ServerMomentum
from repro_torch.data.synthetic_health import Dataset
from repro_torch.device import configure_numerics, resolve_device, upload
from repro_torch.engine.cohort import StreamCohortPlan, _cohort_epoch_flat
from repro_torch.engine.flatten import BACKENDS, FlatPack, flat_mean
from repro_torch.engine.store import PagedShardStore
from repro_torch.engine.sync_sim import _mean_loss, _segment_agg_keep
from repro_torch.federated.programs import as_program
from repro_torch.federated.sampling import CohortSpec
from repro_torch.federated.simulation import RoundMetrics, SimResult, evaluate, initial_params
from repro_torch.telemetry import NULL_TELEMETRY, coerce_telemetry
from repro_torch.telemetry.report import CommDelta
from repro_torch.utils.tree import tree_size_bytes

_CHUNK = 1 << 16


class StreamSyncEngine:
    """Synchronous two-level FedAvg over a lazy population.

    ``source`` is a ``ShardSource``; ``edge_of`` an (M,) int array giving
    each client's edge (-1: unattached).  ``cohort`` (a ``CohortSpec``) is
    required: full participation over a streaming population is what the
    engine exists to avoid (``BatchedSyncEngine`` runs a population that
    fits).  ``page_slots`` sizes the paged store (default twice the
    cohort, at least the cohort); ``server_momentum`` applies cloud
    momentum to the aggregated delta; ``backend`` is "kernel" (the CUDA
    kernels on the card, their plain versions on the CPU) or "reference";
    ``telemetry`` (True, a directory or a ``Telemetry``) records the
    spans and gauges of the module docstring; ``device`` is "cuda" by
    default, raising without CUDA unless "cpu".
    """

    def __init__(
        self,
        source,
        edge_of: np.ndarray,
        program,
        test: Dataset,
        cohort: CohortSpec,
        n_edges: Optional[int] = None,
        schedule: HFLSchedule = HFLSchedule(1, 1),
        seed: int = 0,
        backend: str = "kernel",
        page_slots: Optional[int] = None,
        batch_size: int = 10,
        lr: float = 1e-3,
        max_steps: int = 128,
        server_momentum: float = 0.0,
        telemetry=None,
        device="cuda",
    ):
        if not isinstance(cohort, CohortSpec):
            raise ValueError("StreamSyncEngine requires a CohortSpec cohort")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = resolve_device(device)
        configure_numerics(self.device)
        self.source = source
        self.edge_of = np.ascontiguousarray(edge_of, np.int32)
        self.m = len(self.edge_of)
        if self.m != source.n_clients:
            raise ValueError("edge_of length != source.n_clients")
        self.n_edges = int(n_edges) if n_edges is not None else int(self.edge_of.max()) + 1
        self.program = as_program(program)
        self.test = test
        self.cohort = cohort
        self.schedule = schedule
        self.backend = backend
        self.rng = np.random.default_rng(seed)
        self.params = initial_params(self.program, seed, self.device)
        self.pack = FlatPack(self.params)
        self._sizes = np.asarray(source.sizes)  # the source's array, shared
        edge_sizes = np.zeros(self.n_edges, np.float64)
        n_eligible = 0
        for lo in range(0, self.m, _CHUNK):
            eo = self.edge_of[lo : lo + _CHUNK]
            att = eo >= 0
            n_eligible += int(att.sum())
            edge_sizes += np.bincount(
                eo[att], weights=self._sizes[lo : lo + _CHUNK][att].astype(np.float64), minlength=self.n_edges
            )
        if not n_eligible:
            raise ValueError("no client is attached to any edge")
        # None: every client is attached, and the cohort draw samples ids
        # without an (M,) list of the eligible
        self.eligible = None if n_eligible == self.m else np.flatnonzero(self.edge_of >= 0)
        self._edge_sizes = edge_sizes.astype(np.float32)
        self.plan = StreamCohortPlan(source.sizes, self.program, batch_size=batch_size, lr=lr, max_steps=max_steps)
        # twice the cohort by default, so that the overlap of consecutive
        # rounds pages nothing; still O(cohort) device memory
        capacity = page_slots if page_slots is not None else 2 * cohort.size
        self.store = PagedShardStore(source, max(capacity, cohort.size), self.device)
        model_bits = tree_size_bytes(self.params) * 8
        self.accountant = CommAccountant(model_bits=model_bits)
        self._uplink_bits = self.program.uplink_bits(model_bits)
        self._momentum = ServerMomentum(server_momentum)
        self.tel = coerce_telemetry(telemetry) or NULL_TELEMETRY

    def _edge_round(self, edge_mat: torch.Tensor, b: int, er: int):
        """One edge round over the sampled cohort; returns the new (E, D)
        edge matrix and the members' (C,) losses, still on the device."""
        dev, n, tel = self.device, self.n_edges, self.tel
        with tel.span("assignment", round=b, engine="sync-stream"):
            with tel.span("cohort_draw", round=b):
                members = self.cohort.draw(b, er, eligible=self.eligible, edge_of=self.edge_of, m=self.m)
            with tel.span("batch_plan", round=b, clients=len(members)):
                groups, passthrough = self.plan.draw(self.rng, members, self.schedule.local_steps)
            if tel.enabled:
                tel.metrics.set_gauge("participating", len(members))
        trained = np.concatenate([g.members for g in groups]) if groups else np.zeros(0, np.int64)
        # the round's misses are paged in by one batched write
        with tel.span("page_in", round=b, clients=len(trained)):
            slots = upload(self.store.ensure(trained), dev)
        starts = edge_mat[upload(self.edge_of[trained].astype(np.int64), dev)]
        rows: List[torch.Tensor] = []
        losses: List[torch.Tensor] = []
        off = 0
        for g in groups:
            with tel.span(
                "cohort_epoch", round=b, program=g.program.name, clients=len(g.members), epochs=g.epochs,
                steps=g.steps, batch=g.batch,
            ):
                rows_g = slice(off, off + len(g.members))
                off = rows_g.stop
                idx = upload(g.idx.astype(np.int64), dev)  # (C, epochs, steps, batch)
                flat = starts[rows_g]
                for e in range(g.epochs):
                    xb, yb = self.store.gather_slots(slots[rows_g], idx[:, e])
                    flat, loss = _cohort_epoch_flat(flat, xb, yb, self.pack.spec, g.program, g.steps, g.lr)
                if self.program.quantizes_upload:
                    flat = self.program.quantize_upload(starts[rows_g], flat)
            rows.append(flat)
            losses.append(loss)
        if len(passthrough):
            # empty shards take part with weight 0: they move no edge model,
            # but count for ``has`` and for the accounting
            losses.append(torch.zeros(len(passthrough), device=dev))
        cids = np.concatenate([trained, passthrough])
        seg = self.edge_of[cids]
        with tel.span("edge_aggregate", round=b, clients=len(cids), edges=n):
            has = np.bincount(seg, minlength=n) > 0
            # the sampled members' FedAvg, every edge in one call: the
            # weights renormalize over the cohort, and an edge with no
            # sampled member keeps its model
            upd = torch.cat(rows) if len(rows) > 1 else (rows[0] if rows else edge_mat[:0])
            edge_mat = _segment_agg_keep(
                upd,
                upload(self.edge_of[trained].astype(np.int64), dev),
                upload(self._sizes[trained].astype(np.float32), dev),
                upload(has, dev),
                edge_mat,
                n,
                self.backend,
            )
        # the cohort's compact accounting, with the true client ids
        lam = np.zeros((len(cids), n), np.int8)
        lam[np.arange(len(cids)), seg] = 1
        self.accountant.on_edge_sync(lam, uplink_bits=self._uplink_bits, row_ids=cids)
        return edge_mat, losses

    def run(self, cloud_rounds: int, eval_every: int = 1) -> SimResult:
        n = self.n_edges
        history: List[RoundMetrics] = []
        global_row = self.pack.ravel(self.params)
        edge_sizes = torch.as_tensor(self._edge_sizes, device=self.device)  # once per run
        comm = CommDelta(self.accountant) if self.tel.enabled else None
        wall_accum = 0.0
        for b in range(1, cloud_rounds + 1):
            t_round = time.perf_counter()
            acc = None
            with self.tel.span("cloud_round", round=b, engine="sync-stream"):
                # every edge starts from the global model, in a matrix that
                # owns its rows
                edge_mat = global_row.repeat(n, 1)
                chunks: List[torch.Tensor] = []
                for k in range(self.schedule.edge_per_cloud):
                    edge_mat, round_chunks = self._edge_round(edge_mat, b, k + 1)
                    chunks += round_chunks
                with self.tel.span("cloud_reduce", round=b, edges=n):
                    global_row = self._momentum(global_row, flat_mean(edge_mat, edge_sizes, backend=self.backend))
                self.accountant.on_cloud_sync(n)
                if b % eval_every == 0 or b == cloud_rounds:
                    with self.tel.span("eval", round=b) as sp:
                        acc = evaluate(self.pack.unravel(global_row), self.program, self.test)
                        sp.set(acc=acc)
            loss = _mean_loss(chunks)
            round_wall = time.perf_counter() - t_round
            wall_accum += round_wall
            if acc is not None:
                history.append(RoundMetrics(b, acc, 0.0, loss, wall_seconds=wall_accum))
                wall_accum = 0.0
            if self.tel.enabled:
                if acc is not None:
                    self.tel.metrics.set_gauge("eval_acc", acc)
                self.tel.metrics.set_gauge("page_hits", self.store.hits)
                self.tel.metrics.set_gauge("page_misses", self.store.misses)
                self.tel.metrics.set_gauge("page_evictions", self.store.evictions)
                self.tel.on_round(
                    engine="sync-stream", round=b, acc=acc, loss=loss if chunks else None, wall_s=round_wall,
                    sim_s=None, **comm.take(),
                )
        self.params = self.pack.unravel(global_row)
        return SimResult(history, self.accountant, self.params, telemetry=self.tel if self.tel.enabled else None)
