"""Flat-buffer views of client parameter trees, and the FedAvg primitives.

The engine keeps model state flat: clients exchange (D,) rows, edge models
live in one (E, D) matrix, and FedAvg runs on (N, D) matrices.
``FlatPack`` converts trees <-> rows in JAX's leaf order, so a row here is
the reference's row element for element.  Two weighted averages sit on
top, each with two backends:

  * ``flat_mean``         — one weighted average over an (N, D) matrix;
  * ``flat_segment_mean`` — every segment of an (N, D) matrix at once ->
                            (E, D).

``backend="kernel"`` (the engine's default) calls the kernels' public
wrappers, which launch the CUDA kernels on CUDA tensors and take their
plain versions on CPU tensors; ``backend="reference"`` is the plain
contraction.

Every call goes to the kernel, whatever its size.  The reference package
sends ``flat_mean`` calls of at most 8 rows to a jitted contraction
(``_SMALL_N``) only because its kernel's jit cache is keyed on (N, D) and
would compile afresh per row count; eager PyTorch has no such cache.  It
sends more than 32 segments to a scatter-add (``_MAX_ONEHOT_SEGMENTS``)
only because its kernel is a one-hot contraction costing O(E*N*D); the
CUDA kernel reads each row once into its own segment, O(N*D) for any E.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import hier_aggregate, hier_segment_aggregate, hier_segment_aggregate_ref
from repro_torch.utils.tree import TreeSpec, tree_leaves, tree_ravel, tree_spec, tree_unflatten, tree_unravel

BACKENDS = ("kernel", "reference")


class FlatPack:
    """Tree <-> flat-row converter bound to one model layout.

    Every leaf must share one dtype: the flat row is one buffer, so a mixed
    tree would promote on ravel and cast back on unravel.  Unlike JAX
    without x64, PyTorch keeps float64, so a float64 leaf beside float32
    ones is refused too.
    """

    def __init__(self, template_tree):
        self.spec: TreeSpec = tree_spec(template_tree)
        if len(set(self.spec.dtypes)) > 1:
            raise ValueError(
                "FlatPack requires a uniform leaf dtype for an exact "
                f"ravel/unravel round-trip; got {sorted(set(map(str, self.spec.dtypes)))}"
            )

    @property
    def dim(self) -> int:
        return self.spec.total_size

    def ravel(self, tree) -> torch.Tensor:
        flat, spec = tree_ravel(tree)
        if spec.shapes != self.spec.shapes or spec.paths != self.spec.paths:
            raise ValueError("tree layout does not match FlatPack template")
        return flat

    def unravel(self, flat: torch.Tensor) -> dict:
        return tree_unravel(self.spec, flat)

    def stack(self, trees: Sequence) -> torch.Tensor:
        """Ravel N trees into the (N, D) update matrix."""
        return torch.stack([self.ravel(t) for t in trees], dim=0)

    def ravel_batched(self, stacked_tree) -> torch.Tensor:
        """Tree with a leading cohort axis C on every leaf -> (C, D) matrix."""
        return ravel_batched(stacked_tree)

    def unravel_batched(self, mat: torch.Tensor) -> dict:
        """(C, D) matrix -> tree with a leading cohort axis C on every leaf."""
        return unravel_batched(self.spec, mat)


def ravel_batched(stacked_tree) -> torch.Tensor:
    """Tree with a leading cohort axis C on every leaf -> (C, D) matrix."""
    leaves = tree_leaves(stacked_tree)
    return torch.cat([l.reshape(l.shape[0], -1) for l in leaves], dim=1)


def unravel_batched(spec: TreeSpec, mat: torch.Tensor) -> dict:
    """(C, D) matrix -> tree with a leading cohort axis C on every leaf.

    The leaves are views (or, where a slice is not contiguous, copies) of
    ``mat``'s columns, so autograd carries their gradients back to ``mat``."""
    c = mat.shape[0]
    leaves = []
    off = 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        leaves.append(mat[:, off : off + size].reshape((c,) + shape).to(dtype))
        off += size
    return tree_unflatten(spec.paths, leaves)


def compress_flat_upload(spec, errors: dict, key, start_row: torch.Tensor, trained_row: torch.Tensor):
    """Apply a ``CompressionSpec`` to a flat model delta with error feedback.

    The spec is applied to the whole (D,) delta at once (one global top-k
    over every parameter), unlike the readable simulator's per-leaf
    application.  ``errors[key]`` holds the client's error-feedback state
    and is updated in place."""
    if spec is None or spec.kind == "none":
        return trained_row
    return compress_flat_rows(spec, errors, [key], start_row[None], trained_row[None])[0]


def compress_flat_rows(spec, errors: dict, keys, start_rows: torch.Tensor, trained_rows: torch.Tensor):
    """:func:`compress_flat_upload` for C clients at once: (C, D) start and
    trained rows, ``keys[c]`` naming row c's error state.  One batched
    compression over the (C, D) deltas; each row's result, and the error
    state it leaves, equal the one-row call's."""
    delta = trained_rows - start_rows
    prior = [errors.get(k) for k in keys]
    if all(e is None for e in prior):
        error = torch.zeros_like(delta)
    else:
        error = torch.stack([torch.zeros_like(delta[0]) if e is None else e for e in prior])
    sparse, err = spec.apply_rows(delta + error)
    for c, k in enumerate(keys):
        errors[k] = err[c]
    return start_rows + sparse


def _weights(weights, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(weights, dtype=torch.float32, device=device)


def flat_mean(updates: torch.Tensor, weights, *, backend: str = "kernel") -> torch.Tensor:
    """Weighted average over the leading axis of an (N, D) update matrix."""
    w = _weights(weights, updates.device)
    if backend == "kernel":
        return hier_aggregate(updates.contiguous(), w)
    if backend == "reference":
        w = w / w.sum()
        return torch.tensordot(w, updates.to(torch.float32), dims=1).to(updates.dtype)
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def flat_segment_mean(
    updates: torch.Tensor, seg_ids, weights, n_segments: int, *, backend: str = "kernel"
) -> torch.Tensor:
    """Every segment's weighted average at once: (N, D) -> (n_segments, D).

    The engine uses this for per-edge FedAvg (segments = edges) and DCA
    start averaging (segments = clients).  Empty / zero-weight segments
    return zero rows; callers overlay prior state.
    """
    seg = torch.as_tensor(seg_ids, device=updates.device)
    w = _weights(weights, updates.device)
    if backend == "kernel":
        return hier_segment_aggregate(updates.contiguous(), seg, w, n_segments)
    if backend == "reference":
        return hier_segment_aggregate_ref(updates, seg, w, n_segments)
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
