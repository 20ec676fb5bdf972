"""Batched HFL simulation engine.

====================  =====================================================
module                role
====================  =====================================================
``flatten``           tree <-> (N, D) flat update matrices; ``flat_mean``
                      and ``flat_segment_mean`` run FedAvg on the CUDA
                      kernels (``backend="kernel"``) or the plain
                      contraction (``backend="reference"``)
``store``             ``DeviceShardStore`` — all client shards padded into
                      one (M, n_max, L, Ch) device tensor; cohort batches
                      gathered on the device from sample indices;
                      ``PagedShardStore`` — the streaming variant, a
                      fixed slab of LRU-paged slots over a lazy source
``cohort``            same-shape client cohorts trained in one batched
                      step; ``CohortPlan`` draws their batches (device
                      pipeline), ``LocalJob`` / ``make_job`` /
                      ``run_cohorts`` train per-round jobs (host
                      pipeline), ``StreamCohortPlan`` groups a sampled
                      cohort from the shard sizes alone
``sync_sim``          ``BatchedSyncEngine`` — the reference's synchronous
                      semantics; ``pipeline="device"`` (default) or
                      ``"host"`` (per-edge ``flat_mean`` loop)
``mesh_sim``          ``MeshSyncEngine`` — the device pipeline with the
                      edges split over the ranks of an edge mesh (one
                      process per rank; the cloud reduce is the one
                      collective); ``MeshCommLedger`` counts the bytes
                      each program hands to collectives;
                      ``mesh_segment_mean`` is its edge FedAvg alone
``events``            ``EventQueue`` — the (time, seq) heap of the async
                      engine (copied from the reference)
``async_sim``         ``AsyncHFLEngine`` — quorum flushes, staleness
                      decay, the cloud barrier, on the simulated clock
``stream_sim``        ``StreamSyncEngine`` — the population M as a
                      streaming axis: a sampled cohort per edge round,
                      shards paged from a lazy source, O(cohort) device
                      state
``distill``           distillation aggregation for heterogeneous-MODEL
                      populations: per-architecture FedAvg stays flat, and
                      each edge's group models are fused by ensemble logit
                      distillation on a public shard (``DistillSpec``,
                      ``distill_fuse_flat``, ``distill_edge``)
====================  =====================================================

Mixed-model populations come from ``build_scenario(model_mix={...})``.
"""
from repro_torch.engine.async_sim import AsyncHFLEngine
from repro_torch.engine.cohort import (
    CohortPlan,
    LocalJob,
    StreamCohortPlan,
    draw_batch_indices,
    make_job,
    pack_for,
    run_cohorts,
)
from repro_torch.engine.distill import (
    DistillSpec,
    distill_edge,
    distill_fuse_flat,
    draw_public_batches,
    kd_loss,
    soft_targets,
)
from repro_torch.engine.events import Event, EventQueue
from repro_torch.engine.flatten import (
    BACKENDS,
    FlatPack,
    compress_flat_rows,
    compress_flat_upload,
    flat_mean,
    flat_segment_mean,
)
from repro_torch.engine.mesh_sim import MeshCommLedger, MeshSyncEngine, mesh_segment_mean
from repro_torch.engine.store import DeviceShardStore, PagedShardStore
from repro_torch.engine.stream_sim import StreamSyncEngine
from repro_torch.engine.sync_sim import PIPELINES, BatchedSyncEngine

__all__ = [
    "AsyncHFLEngine",
    "BACKENDS",
    "BatchedSyncEngine",
    "CohortPlan",
    "DeviceShardStore",
    "DistillSpec",
    "Event",
    "EventQueue",
    "FlatPack",
    "LocalJob",
    "MeshCommLedger",
    "MeshSyncEngine",
    "PIPELINES",
    "PagedShardStore",
    "StreamCohortPlan",
    "StreamSyncEngine",
    "compress_flat_rows",
    "compress_flat_upload",
    "distill_edge",
    "distill_fuse_flat",
    "draw_batch_indices",
    "draw_public_batches",
    "flat_mean",
    "flat_segment_mean",
    "kd_loss",
    "make_job",
    "mesh_segment_mean",
    "pack_for",
    "run_cohorts",
    "soft_targets",
]
