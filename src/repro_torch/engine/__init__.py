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
                      step; ``CohortPlan`` draws their batches
``sync_sim``          ``BatchedSyncEngine`` — the reference's synchronous
                      semantics, device pipeline
====================  =====================================================
"""
from repro_torch.engine.cohort import CohortPlan, draw_batch_indices
from repro_torch.engine.flatten import BACKENDS, FlatPack, flat_mean, flat_segment_mean
from repro_torch.engine.store import DeviceShardStore
from repro_torch.engine.sync_sim import PIPELINES, BatchedSyncEngine

__all__ = [
    "BACKENDS",
    "BatchedSyncEngine",
    "CohortPlan",
    "DeviceShardStore",
    "FlatPack",
    "PIPELINES",
    "draw_batch_indices",
    "flat_mean",
    "flat_segment_mean",
]
