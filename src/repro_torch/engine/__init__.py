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
                      gathered on the device from sample indices
``cohort``            same-shape client cohorts trained in one batched
                      step; ``CohortPlan`` draws their batches (device
                      pipeline), ``LocalJob`` / ``make_job`` /
                      ``run_cohorts`` train per-round jobs (host pipeline)
``sync_sim``          ``BatchedSyncEngine`` — the reference's synchronous
                      semantics; ``pipeline="device"`` (default) or
                      ``"host"`` (per-edge ``flat_mean`` loop)
``events``            ``EventQueue`` — the (time, seq) heap of the async
                      engine (copied from the reference)
``async_sim``         ``AsyncHFLEngine`` — quorum flushes, staleness
                      decay, the cloud barrier, on the simulated clock
====================  =====================================================
"""
from repro_torch.engine.async_sim import AsyncHFLEngine
from repro_torch.engine.cohort import CohortPlan, LocalJob, draw_batch_indices, make_job, run_cohorts
from repro_torch.engine.events import Event, EventQueue
from repro_torch.engine.flatten import (
    BACKENDS,
    FlatPack,
    compress_flat_rows,
    compress_flat_upload,
    flat_mean,
    flat_segment_mean,
)
from repro_torch.engine.store import DeviceShardStore
from repro_torch.engine.sync_sim import PIPELINES, BatchedSyncEngine

__all__ = [
    "AsyncHFLEngine",
    "BACKENDS",
    "BatchedSyncEngine",
    "CohortPlan",
    "DeviceShardStore",
    "Event",
    "EventQueue",
    "FlatPack",
    "LocalJob",
    "PIPELINES",
    "compress_flat_rows",
    "compress_flat_upload",
    "draw_batch_indices",
    "flat_mean",
    "flat_segment_mean",
    "make_job",
    "run_cohorts",
]
