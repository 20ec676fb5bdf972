"""Hierarchical FL as a training strategy: per-edge model replicas.

The port of ``src/repro/distributed/hfl_mesh.py``.  Parameters and
optimizer states carry a leading E axis, one model replica per edge, each
trained on its own edge's batch and drifting from the others between
cloud syncs; ``make_hfl_train_step(..., sync=True)`` ends the step with the
eq. 8 sigma-weighted average of the replicas.  The two step variants are
built separately (local only, local + cloud sync); a scheduled run
alternates them, T - 1 local steps to one sync.

On an edge mesh (``mesh=``, from ``axes.edge_mesh``) the E axis is split
over the ranks: each rank holds, and is given batches for, its E/k edges,
and the cloud average is its weighted partial sum plus one ``all_reduce``:
the only cross-edge traffic, once per sync step (the metrics add one
(2, E) ``all_reduce`` a step).  With no mesh everything is local.
``hfl_param_specs`` and ``hfl_batch_spec`` give that layout as
PartitionSpecs: the leading E axis over the edge axis, so on a 1-D edge
mesh ``to_placements`` of a leaf's spec is ``Shard(0)``, each rank its
contiguous E/k replicas.  The step also takes a state whose leaves are
DTensors in that layout (``DTensor.from_local`` of the rank's replicas,
no collective): it works on their local shards, in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.axes import EDGE_AXIS, is_dtensor, mesh_rank, mesh_size
from repro_torch.distributed.sharding import P, map_specs
from repro_torch.engine.flatten import flat_mean
from repro_torch.models.config import ModelConfig
from repro_torch.telemetry import NULL_TELEMETRY, coerce_telemetry
from repro_torch.training.optimizers import Optimizer, clip_by_global_norm_
from repro_torch.training.train_step import TrainState, _value_and_grad, make_loss_fn
from repro_torch.utils.tree import tree_leaves, tree_map


def replicate_for_edges(params, n_edges: int):
    """E copies of the global model (edge replicas), each its own storage."""
    return tree_map(lambda x: x[None].expand((n_edges,) + tuple(x.shape)).clone(), params)


def _local_edges(n_edges: int, mesh) -> int:
    k = 1 if mesh is None else mesh_size(mesh)
    if n_edges % k:
        raise ValueError(f"edge count {n_edges} must be divisible by mesh size {k}")
    return n_edges // k


def init_hfl_state(params, optimizer: Optimizer, n_edges: int, *, mesh=None) -> TrainState:
    """Replicas and optimizer state of the edges this rank holds (all
    ``n_edges`` with no mesh, E/k on an edge mesh of k ranks)."""
    ep = replicate_for_edges(params, _local_edges(n_edges, mesh))
    return TrainState(ep, optimizer.init(ep), 0)


def make_hfl_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    sync: bool,
    edge_weights=None,
    grad_clip: float = 1.0,
    sync_opt_state: bool = False,
    mesh=None,
    telemetry=None,
):
    """(state, batch) -> (state, metrics) with per-edge replicas.

    batch leaves: (E, B, S) per-edge token batches (the rank's E/k edges on
    a mesh).  Each edge's loss and gradient, its gradient clipped by ITS
    OWN global norm (a norm over all edges would couple the replicas with
    a cross-edge reduction on every local step), and its Adam step; the
    replicas and moments are updated in their own storage.  With
    ``sync=True`` every replica then becomes the average of all of them
    weighted by ``edge_weights`` (E,) (uniform by default), and so do the
    moments under ``sync_opt_state``: per leaf one ``flat_mean`` (the
    ``hier_aggregate`` kernel on the card) over the rank's replicas.  Metrics, over all E edges: ``total_loss`` (the
    mean), ``grad_norm`` (the largest edge norm), ``edge_loss_spread``.

    ``telemetry`` (True, a directory or a ``Telemetry``, as the engines
    take it) records the span ``hfl_step`` (attrs ``sync``, ``edges``), in
    it per edge ``loss_grad``, ``clip`` and ``adam`` (attr ``edge``), and
    ``cloud_avg`` (attrs ``leaves``, ``sync_opt_state``), and the counters
    ``tokens_trained`` (the rank's E x B x S a step) and ``sync_steps``;
    under a recording ``torch.profiler`` each span is a ``tel:`` range, so
    a step's device time splits by them.  Off, the step is unchanged.
    """
    loss_fn = make_loss_fn(cfg)
    k = 1 if mesh is None else mesh_size(mesh)
    rank = 0 if mesh is None else mesh_rank(mesh)
    group = None if mesh is None else mesh.get_group(EDGE_AXIS)
    weights = None if edge_weights is None else np.asarray(torch.as_tensor(edge_weights).cpu(), np.float64)
    tel = coerce_telemetry(telemetry) or NULL_TELEMETRY

    def cloud_avg_(leaves, e_local: int) -> None:
        n_edges = e_local * k
        w = np.full(n_edges, 1.0 / n_edges) if weights is None else weights
        if len(w) != n_edges:
            raise ValueError(f"edge_weights has {len(w)} entries for {n_edges} edges")
        local = w[rank * e_local : (rank + 1) * e_local]
        share = 1.0 if k == 1 else float(local.sum() / max(w.sum(), 1e-30))
        wt = torch.as_tensor(local.astype(np.float32), device=leaves[0].device)
        for x in leaves:
            avg = flat_mean(x.reshape(e_local, -1), wt).float()
            if share != 1.0:
                avg = avg * share
            if k > 1:
                dist.all_reduce(avg, group=group)
            x.copy_(avg.to(x.dtype).reshape(x.shape[1:]).expand_as(x))

    def step(state: TrainState, batch):
        if is_dtensor(tree_leaves(state.params)[0]):  # the rank's replicas, in place
            out, metrics = step(TrainState(_local(state.params), _local(state.opt_state), state.step),
                                {key: v.to_local() if is_dtensor(v) else v for key, v in batch.items()})
            return TrainState(state.params, state.opt_state, out.step), metrics
        e_local = tree_leaves(state.params)[0].shape[0]
        with tel.span("hfl_step", sync=sync, edges=e_local):
            totals, gnorms = [], []
            for e in range(e_local):
                params_e = tree_map(lambda x: x[e], state.params)
                opt_e = tree_map(lambda x: x[e], state.opt_state)
                with tel.span("loss_grad", edge=e):
                    (total, _), grads = _value_and_grad(loss_fn, params_e, {key: v[e] for key, v in batch.items()})
                with tel.span("clip", edge=e):
                    gnorms.append(clip_by_global_norm_(grads, grad_clip))
                totals.append(total)
                with tel.span("adam", edge=e):
                    if optimizer.update_ is not None:
                        optimizer.update_(params_e, grads, opt_e, state.step)
                    else:
                        with torch.no_grad():
                            new_p, new_o = optimizer.update(params_e, grads, opt_e, state.step)
                            for dst, src in zip(tree_leaves((params_e, opt_e)), tree_leaves((new_p, new_o))):
                                dst.copy_(src)
            with torch.no_grad():
                if sync:
                    leaves = tree_leaves(state.params)
                    if sync_opt_state:  # server-side moment averaging (3x the sync payload)
                        leaves = leaves + tree_leaves(state.opt_state)
                    with tel.span("cloud_avg", leaves=len(leaves), sync_opt_state=sync_opt_state):
                        cloud_avg_(leaves, e_local)
                per_edge = torch.stack([torch.stack(totals), torch.stack(gnorms)])
                if k > 1:  # every edge's loss and norm, for the metrics
                    full = torch.zeros((2, e_local * k), dtype=per_edge.dtype, device=per_edge.device)
                    full[:, rank * e_local : (rank + 1) * e_local] = per_edge
                    dist.all_reduce(full, group=group)
                    per_edge = full
            if tel.enabled:
                tel.metrics.inc("tokens_trained", batch["tokens"].numel())
                tel.metrics.inc("sync_steps", int(sync))
            totals_all, gnorms_all = per_edge
            metrics = {
                "total_loss": totals_all.mean(),
                "grad_norm": gnorms_all.max(),
                "edge_loss_spread": totals_all.max() - totals_all.min(),
            }
            return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step


def _local(tree):
    return tree_map(lambda x: x.to_local(), tree)


def hfl_param_specs(base_specs, edge_axes=("edge",)):
    """Prepend the edge-replica axis to every parameter PartitionSpec."""
    ax = edge_axes if len(edge_axes) > 1 else edge_axes[0]
    return map_specs(lambda spec: P(ax, *spec), base_specs)


def hfl_batch_spec(edge_axes=("edge",), batch_axes=("eu",)):
    ea = edge_axes if len(edge_axes) > 1 else edge_axes[0]
    ba = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    return P(ea, ba, None)
