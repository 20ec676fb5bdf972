"""Weighted FedAvg of an (N, D) matrix into one (D,) row.

Replaces the Pallas kernel ``hier_aggregate`` of the reference
(``src/repro/kernels/hier_aggregate.py``: ``_agg_kernel``).  The engine
calls it for the cloud reduce (paper eq. 8/9) over the (E, D) edge matrix.

What bounds it on an H100: bytes — reading the (N, D) updates once and
writing the (D,) result once at the memory rate.  The heartbeat cloud
reduce (N = 5, D = 25,141, fp32) moves 0.6 MB, about 0.2 us at 3.35 TB/s,
far below a launch's own latency: the kernel is launch-bound.

Design (``csrc/aggregate.cu``): one launch per call, from the raw weights;
the wrapper prepares nothing on the device and never synchronises.  Each
thread owns a column and sends out at once the loads of 8 rows of x (N <=
8; a larger N goes in chunks of 32) and of the weight of row ``lane``.  The kernel then adds the weights
in row order (handed round the warp by shuffles), clamps the sum at 1e-30,
has each lane divide its own row's weight by it (one IEEE division per
lane), and adds the rounded products in row order, as the segment kernel
and the plain version do.  At the cloud reduce's N = 5 that is one round
trip of loads; the chain of adds and the division after it are what
in-kernel normalization costs.
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
    takes_plain,
)


def hier_aggregate_ref(updates, weights) -> torch.Tensor:
    """Plain PyTorch version: the weights normalized by their sum (clamped
    at 1e-30), contracted with the rows in fp32, cast back to the input
    dtype."""
    w = weights.to(torch.float32)
    wn = w / w.sum().clamp_min(1e-30)
    return torch.einsum("n,nd->d", wn, updates.to(torch.float32)).to(updates.dtype)


def _launch(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on checked inputs (N, D > 0): ``weights``
    fp32, contiguous, raw.  Counts nothing."""
    n, d = updates.shape
    lib = load_library()
    with torch.cuda.device(updates.device):
        out = torch.empty((d,), dtype=updates.dtype, device=updates.device)
        entry = (
            lib.repro_aggregate_f32 if updates.dtype == torch.float32 else lib.repro_aggregate_bf16
        )
        code = entry(ptr(updates), ptr(weights), ptr(out), n, d, stream_of(updates.device))
    check_launch(code, "hier_aggregate")
    return out


def hier_aggregate(updates, weights) -> torch.Tensor:
    """updates: (N, D) fp32/bf16; weights: (N,).  Returns the (D,) weighted
    average in the input dtype.

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel (one launch, counted in ``hier_aggregate.launches``, and nothing
    that waits for the card) or raise.
    """
    name = "hier_aggregate"
    check_updates(updates, name)
    n, d = updates.shape
    check_rows(weights, n, updates.device, "weights", name, integer=False)
    if takes_plain(updates):
        return hier_aggregate_ref(updates, weights)
    if n == 0 or d == 0:
        return torch.zeros((d,), dtype=updates.dtype, device=updates.device)
    out = _launch(updates, weights.to(torch.float32).contiguous())
    hier_aggregate.launches += 1
    return out


hier_aggregate.launches = 0
