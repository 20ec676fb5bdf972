"""Weighted FedAvg of an (N, D) matrix into one (D,) row.

Replaces the Pallas kernel ``hier_aggregate`` of the reference
(``src/repro/kernels/hier_aggregate.py``: ``_agg_kernel``).  The engine
calls it for the cloud reduce (paper eq. 8/9) over the (E, D) edge matrix.

What bounds it on an H100: bytes — reading the (N, D) updates once and
writing the (D,) result once at the memory rate.  The heartbeat cloud
reduce (N = 5, D = 25,141, fp32) moves 0.6 MB, about 0.2 us at 3.35 TB/s,
far below a launch's own latency: the kernel is launch-bound.

Design (``csrc/aggregate.cu``): one thread owns one column and sums
``wn[i] * x[i, col]`` over the rows in an fp32 register, then writes the
column once in the input dtype.  The weights, normalized by their sum
(clamped at 1e-30), are O(N) scalars built beside the launch in plain torch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import (
    check_launch,
    check_rows,
    check_updates,
    ptr,
    stream_of,
)


def _normalized_weights(weights: torch.Tensor) -> torch.Tensor:
    w = weights.to(torch.float32)
    return w / w.sum().clamp_min(1e-30)


def hier_aggregate_ref(updates, weights) -> torch.Tensor:
    """Plain PyTorch version: normalized weights contracted with the rows
    in fp32, cast back to the input dtype."""
    wn = _normalized_weights(weights)
    return torch.einsum("n,nd->d", wn, updates.to(torch.float32)).to(updates.dtype)


def _launch(updates: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on checked inputs (``wn`` fp32, normalized).
    Counts nothing."""
    n, d = updates.shape
    lib = load_library()
    with torch.cuda.device(updates.device):
        out = torch.empty((d,), dtype=updates.dtype, device=updates.device)
        entry = (
            lib.repro_aggregate_f32 if updates.dtype == torch.float32 else lib.repro_aggregate_bf16
        )
        code = entry(ptr(updates), ptr(wn), ptr(out), n, d, stream_of(updates.device))
    check_launch(code, "hier_aggregate")
    return out


def hier_aggregate(updates, weights) -> torch.Tensor:
    """updates: (N, D) fp32/bf16; weights: (N,).  Returns the (D,) weighted
    average in the input dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count one launch in ``hier_aggregate.launches``) or raise.
    """
    name = "hier_aggregate"
    check_updates(updates, name)
    n, d = updates.shape
    check_rows(weights, n, updates.device, "weights", name, integer=False)
    if updates.device.type == "cpu":
        return hier_aggregate_ref(updates, weights)
    if n == 0 or d == 0:
        return torch.zeros((d,), dtype=updates.dtype, device=updates.device)
    out = _launch(updates, _normalized_weights(weights))
    hier_aggregate.launches += 1
    return out


hier_aggregate.launches = 0
