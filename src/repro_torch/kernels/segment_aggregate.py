"""Segmented weighted FedAvg: every segment's average of an (N, D) matrix.

Replaces the Pallas kernel ``hier_segment_aggregate`` of the reference
(``src/repro/kernels/segment_aggregate.py``: ``_seg_kernel`` and
``_segment_weight_matrix``).  The engine calls it for the per-edge FedAvg
(segments = edges, paper eq. 6/8) and for the DCA start rows (segments =
clients).

What bounds it on an H100: bytes.  The work is one multiply-add per input
element, so the least time is reading the (N, D) updates once and writing
the (E, D) result once at the memory rate (3.35 TB/s on the SXM part).  At
the heartbeat edge FedAvg (N = 18, E = 5, D = 25,141, fp32) that is 2.3 MB,
about 0.7 us — below the few microseconds a launch itself takes, so the
kernel is launch-bound at the engine's sizes.

Design (``csrc/aggregate.cu``): one launch per call, from the raw ids
(int32 or int64) and the raw weights; the wrapper prepares nothing on the
device and never synchronises.  Each block owns one segment and a tile of
columns, one fp32 register sum per column.  Every warp finds the segment's
member rows itself (a ballot over 32 ids at a time, any N; no shared
memory, no block barrier) and sends the loads of their rows of x out at
once; the denominator (the members' weights in row order, clamped at 1e-30,
the same bits in every block) and each member's ``w / W`` are worked out
while those loads are in flight.  The members are then added in row order,
each product ``w / W * x`` rounded as the plain version rounds it.  A block
reads only its segment's rows, with no atomics and no sort, so the kernel
is two dependent loads deep: the ids, then x.  The TPU kernel's one-hot
(E, N) @ (N, block) contraction is not carried over: it costs O(E*N*D)
operations, and a non-member row holding inf or NaN would poison every
segment through 0 * inf = NaN.
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


def hier_segment_aggregate_ref(updates, seg_ids, weights, n_segments: int) -> torch.Tensor:
    """Plain PyTorch version: per-segment-normalized weights (the sums go
    through an (E, N) mask and a row sum rather than a scatter, whose
    atomics on the card would add in a different order from run to run),
    then one ``index_add_`` scatter in fp32; empty segments are zero rows;
    the result is cast back to the input dtype.  A row whose id lies
    outside [0, n_segments) belongs to no segment and adds nothing, as in
    the TPU kernel's one-hot and the reference's ``segment_sum``."""
    seg = seg_ids.to(torch.int64)
    # ids outside [0, n_segments) go to a spare last row, dropped at the end
    seg = torch.where((seg >= 0) & (seg < n_segments), seg, n_segments)
    w = weights.to(torch.float32)
    member = seg[None, :] == torch.arange(n_segments + 1, device=w.device)[:, None]
    denom = torch.where(member, w[None, :], 0.0).sum(dim=1)
    wn = w / denom.clamp_min(1e-30)[seg]
    out = torch.zeros((n_segments + 1, updates.shape[1]), dtype=torch.float32, device=updates.device)
    out.index_add_(0, seg, updates.to(torch.float32) * wn[:, None])
    return out[:n_segments].to(updates.dtype)


def _launch(updates: torch.Tensor, seg_ids: torch.Tensor, weights: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Launch the CUDA kernel on checked inputs (N, D, n_segments > 0):
    ``seg_ids`` int32 or int64 and ``weights`` fp32, both contiguous.
    Counts nothing."""
    n, d = updates.shape
    lib = load_library()
    with torch.cuda.device(updates.device):
        out = torch.empty((n_segments, d), dtype=updates.dtype, device=updates.device)
        entry = (
            lib.repro_segment_aggregate_f32
            if updates.dtype == torch.float32
            else lib.repro_segment_aggregate_bf16
        )
        code = entry(
            ptr(updates), ptr(seg_ids), int(seg_ids.dtype == torch.int64), ptr(weights), ptr(out),
            n, d, n_segments, stream_of(updates.device),
        )
    check_launch(code, "hier_segment_aggregate")
    return out


def hier_segment_aggregate(updates, seg_ids, weights, n_segments: int) -> torch.Tensor:
    """updates: (N, D) fp32/bf16; seg_ids: (N,) int32/int64; weights: (N,).
    Returns (n_segments, D) per-segment weighted averages in the input
    dtype; empty (or zero-weight) segments are zero rows and a
    single-member segment is exactly its row.

    An id outside [0, n_segments) belongs to no segment and adds nothing,
    as in the TPU kernel, on both routes.  CPU and meta tensors take the
    plain version; CUDA tensors launch the kernel (one launch, counted in
    ``hier_segment_aggregate.launches``) or raise, and the wrapper never
    waits for the card to check the ids.
    """
    name = "hier_segment_aggregate"
    check_updates(updates, name)
    n, d = updates.shape
    check_rows(seg_ids, n, updates.device, "seg_ids", name, integer=True)
    check_rows(weights, n, updates.device, "weights", name, integer=False)
    if int(n_segments) != n_segments or n_segments < 0:
        raise ValueError(f"{name}: n_segments must be a non-negative int, got {n_segments!r}")
    n_segments = int(n_segments)
    if takes_plain(updates):
        return hier_segment_aggregate_ref(updates, seg_ids, weights, n_segments)
    if n == 0 or d == 0 or n_segments == 0:
        return torch.zeros((n_segments, d), dtype=updates.dtype, device=updates.device)
    out = _launch(updates, seg_ids.contiguous(), weights.to(torch.float32).contiguous(), n_segments)
    hier_segment_aggregate.launches += 1
    return out


hier_segment_aggregate.launches = 0
