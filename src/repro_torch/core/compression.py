"""Model-update compression baselines (the paper's related work [4],[16],[17]).

The paper positions EARA against communication-efficient FL by
sparsification and quantization; these are the standard schemes, usable on
top of the hierarchical assignment (EARA cuts rounds, compression cuts bits
per round):

  * top-k sparsification with error feedback (Aji & Heafield '17);
  * ternary quantization with a per-tensor scale (STC, Sattler et al. '20,
    simplified: no Golomb coding, bits counted analytically).

Both are plain PyTorch over parameter trees (a bare tensor is a tree of
one leaf); ``CompressionSpec.bits(tree)`` gives the on-the-wire payload for
the ``CommAccountant``, in the same integer arithmetic as the reference, so
the two packages' traffic totals compare with ``==``.

Top-k keeps exactly k entries per leaf and breaks ties at the cutoff by
the lower position, as ``jax.lax.top_k`` does: the selection is a stable
descending sort of the magnitudes (``torch.topk`` promises no tie order).
Every function also takes a leading batch of rows (``topk_rows``,
``ternarize_rows``), each row compressed on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_num_params


def _topk_keep(n: int, fraction: float) -> int:
    """Entries top-k keeps of ``n``: ``max(1, ceil(n * fraction))``."""
    return max(1, int(np.ceil(n * fraction)))


def topk_rows(xe: torch.Tensor, fraction: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of every row of a (C, D) matrix: (kept, rest), ``kept`` holding
    each row's ``max(1, ceil(D * fraction))`` largest-magnitude entries
    (ties to the lower column) and ``rest = xe - kept``."""
    k = _topk_keep(xe.shape[1], fraction)
    order = torch.sort(xe.abs(), dim=1, descending=True, stable=True).indices
    mask = torch.zeros(xe.shape, dtype=torch.bool, device=xe.device)
    mask.scatter_(1, order[:, :k], True)
    kept_per_row = mask.sum(dim=1)
    assert bool((kept_per_row == k).all()), f"top-k kept {kept_per_row.tolist()} != k={k}"
    kept = torch.where(mask, xe, torch.zeros((), dtype=xe.dtype, device=xe.device))
    return kept, xe - kept


def ternarize_rows(xe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """STC ternarization of every row of a (C, D) matrix: (q, xe - q), with
    ``q = mu * sign(xe)`` on the entries at or above the row's mean
    magnitude and ``mu`` the mean magnitude of those entries."""
    mag = xe.abs()
    thresh = mag.mean(dim=1, keepdim=True)
    mask = mag >= thresh
    count = mask.sum(dim=1, keepdim=True).clamp_min(1)
    mu = (mag * mask).sum(dim=1, keepdim=True) / count
    zero = torch.zeros((), dtype=xe.dtype, device=xe.device)
    q = torch.where(mask, mu * torch.sign(xe), zero).to(xe.dtype)
    return q, xe - q


def _per_leaf(rows_fn, tree, error):
    """``rows_fn`` on each leaf of ``tree + error`` as one row; returns the
    (compressed tree, new error tree)."""
    if error is None:
        error = tree_map(torch.zeros_like, tree)
    pairs = tree_map(lambda x, e: rows_fn((x + e).reshape(1, -1)), tree, error)
    first = tree_map(lambda x, p: p[0].reshape(x.shape), tree, pairs)
    second = tree_map(lambda x, p: p[1].reshape(x.shape), tree, pairs)
    return first, second


def topk_sparsify(tree, fraction: float, error=None):
    """Keep the largest-magnitude ``fraction`` of entries per leaf (exactly
    ``max(1, ceil(size * fraction))``); the rest accumulate into the
    error-feedback state.  Returns (sparse_tree, new_error)."""
    return _per_leaf(lambda xe: topk_rows(xe, fraction), tree, error)


def ternarize(tree, error=None):
    """STC-style ternarization per leaf, error feedback as above.  Returns
    (ternary_tree, new_error)."""
    return _per_leaf(ternarize_rows, tree, error)


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """An uplink compression and its payload accounting."""

    kind: str = "none"  # none | topk | ternary
    fraction: float = 0.01  # top-k keep fraction
    index_bits: int = 32
    value_bits: int = 32

    def bits(self, tree) -> float:
        n = tree_num_params(tree)
        if self.kind == "none":
            return float(n * self.value_bits)
        if self.kind == "topk":
            k = sum(_topk_keep(leaf.numel(), self.fraction) for leaf in tree_leaves(tree))
            return float(k * (self.index_bits + self.value_bits))
        if self.kind == "ternary":
            # ~half the entries nonzero: 2 bits per entry (dense ternary
            # code) plus one fp32 scale per leaf
            return float(n * 2 + 32 * len(tree_leaves(tree)))
        raise ValueError(self.kind)

    def apply(self, tree, error=None):
        if self.kind == "none":
            return tree, error
        if self.kind == "topk":
            return topk_sparsify(tree, self.fraction, error)
        if self.kind == "ternary":
            return ternarize(tree, error)
        raise ValueError(self.kind)

    def apply_rows(self, xe: torch.Tensor):
        """The compression of each row of a (C, D) matrix (error already
        added): (compressed, new error).  Row c's result equals
        ``apply`` on row c alone."""
        if self.kind == "topk":
            return topk_rows(xe, self.fraction)
        if self.kind == "ternary":
            return ternarize_rows(xe)
        raise ValueError(self.kind)
