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

Design (``csrc/aggregate.cu``): one thread owns one element of the (E, D)
result, walks the rows of its segment and accumulates ``wn[i] * x[i, col]``
in an fp32 register.  Every row of ``x`` is read exactly once for any E,
with no atomics and the rows of a segment summed in their order.  The rows
are grouped by segment beside the launch (a stable sort of the ids plus
per-segment offsets, O(N) scalars), as are the per-row weights normalized
per segment (denominator clamped at 1e-30) — the reference likewise builds
its weight matrix outside its ``pallas_call``.  The TPU kernel's one-hot
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
)


def _normalized_weights(seg_ids: torch.Tensor, weights: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(N,) fp32 ``w_i / max(W_seg(i), 1e-30)``; ``seg_ids`` int64.

    The per-segment sums go through an (E, N) mask and a row sum rather
    than a scatter, whose atomics on the card would add in a different
    order from run to run."""
    w = weights.to(torch.float32)
    member = seg_ids[None, :] == torch.arange(n_segments, device=w.device)[:, None]
    denom = torch.where(member, w[None, :], 0.0).sum(dim=1)
    return w / denom.clamp_min(1e-30)[seg_ids]


def hier_segment_aggregate_ref(updates, seg_ids, weights, n_segments: int) -> torch.Tensor:
    """Plain PyTorch version: per-segment-normalized weights, then one
    ``index_add_`` scatter in fp32; empty segments are zero rows; the
    result is cast back to the input dtype."""
    seg = seg_ids.to(torch.int64)
    wn = _normalized_weights(seg, weights, n_segments)
    out = torch.zeros((n_segments, updates.shape[1]), dtype=torch.float32, device=updates.device)
    out.index_add_(0, seg, updates.to(torch.float32) * wn[:, None])
    return out.to(updates.dtype)


def _segment_runs(seg64: torch.Tensor, n_segments: int):
    """(rows, offs), both int32: the row indices grouped by segment (a
    stable sort, so each segment keeps its rows' order) and the (E + 1,)
    offsets of each segment's run in ``rows``."""
    rows = torch.sort(seg64, stable=True).indices.to(torch.int32)
    # counts from a mask, not ``bincount``, which synchronises on the card
    member = seg64[None, :] == torch.arange(n_segments, device=seg64.device)[:, None]
    offs = torch.zeros(n_segments + 1, dtype=torch.int32, device=seg64.device)
    offs[1:] = torch.cumsum(member.sum(dim=1), 0)
    return rows, offs


def _launch(updates: torch.Tensor, rows: torch.Tensor, offs: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on checked inputs: ``rows``/``offs`` from
    :func:`_segment_runs`, ``wn`` the fp32 normalized weights.  Counts
    nothing."""
    d = updates.shape[1]
    n_segments = offs.shape[0] - 1
    lib = load_library()
    with torch.cuda.device(updates.device):
        out = torch.empty((n_segments, d), dtype=updates.dtype, device=updates.device)
        entry = (
            lib.repro_segment_aggregate_f32
            if updates.dtype == torch.float32
            else lib.repro_segment_aggregate_bf16
        )
        code = entry(
            ptr(updates), ptr(rows), ptr(offs), ptr(wn), ptr(out), d, n_segments,
            stream_of(updates.device),
        )
    check_launch(code, "hier_segment_aggregate")
    return out


def hier_segment_aggregate(updates, seg_ids, weights, n_segments: int) -> torch.Tensor:
    """updates: (N, D) fp32/bf16; seg_ids: (N,) int in [0, n_segments);
    weights: (N,).  Returns (n_segments, D) per-segment weighted averages in
    the input dtype; empty (or zero-weight) segments are zero rows and a
    single-member segment is exactly its row.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count one launch in ``hier_segment_aggregate.launches``) or raise.
    """
    name = "hier_segment_aggregate"
    check_updates(updates, name)
    n, d = updates.shape
    check_rows(seg_ids, n, updates.device, "seg_ids", name, integer=True)
    check_rows(weights, n, updates.device, "weights", name, integer=False)
    if int(n_segments) != n_segments or n_segments < 0:
        raise ValueError(f"{name}: n_segments must be a non-negative int, got {n_segments!r}")
    n_segments = int(n_segments)
    if n and bool(((seg_ids < 0) | (seg_ids >= n_segments)).any()):
        raise ValueError(f"{name}: seg_ids must lie in [0, {n_segments})")
    if updates.device.type == "cpu":
        return hier_segment_aggregate_ref(updates, seg_ids, weights, n_segments)
    if n == 0 or d == 0 or n_segments == 0:
        return torch.zeros((n_segments, d), dtype=updates.dtype, device=updates.device)
    seg64 = seg_ids.to(torch.int64)
    wn = _normalized_weights(seg64, weights, n_segments)
    out = _launch(updates, *_segment_runs(seg64, n_segments), wn)
    hier_segment_aggregate.launches += 1
    return out


hier_segment_aggregate.launches = 0
