"""Class-distribution objectives from the paper (Sec. 5.1).

The P1 objective (eq. 19) sums over edges the KL divergence between each
edge's virtual-dataset class distribution and the uniform reference
(eq. 18); the pairwise-L1 class-count balance (eq. 29) is its surrogate,
linear in the assignment.  Plain tensor functions; ``class_counts[i, k]``
is the number of samples of class k held by EU i (the paper's c_k^i).
"""
from __future__ import annotations

import itertools

import torch

_EPS = 1e-12


def edge_class_counts(lam: torch.Tensor, class_counts: torch.Tensor) -> torch.Tensor:
    """(N, K) per-edge class counts sum_i lam_ij c_k^i (numerator of eq. 28)."""
    return torch.einsum("ij,ik->jk", lam, class_counts)


def edge_distributions(lam: torch.Tensor, class_counts: torch.Tensor) -> torch.Tensor:
    """H_j(c_k) of eq. 28: normalized per-edge class distribution, (N, K)."""
    counts = edge_class_counts(lam, class_counts)
    return counts / torch.clamp(counts.sum(dim=1, keepdim=True), min=_EPS)


def kld(h: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """D_KL(h || q) of eq. 18 over the last axis."""
    h = torch.clamp(h, min=_EPS)
    q = torch.clamp(q, min=_EPS)
    return torch.sum(h * (torch.log(h) - torch.log(q)), dim=-1)


def total_kld_uniform(lam: torch.Tensor, class_counts: torch.Tensor) -> torch.Tensor:
    """P1 objective (eq. 19): sum_j D_KL(H_j || Uniform)."""
    h = edge_distributions(lam, class_counts)
    k = class_counts.shape[1]
    q = torch.full((k,), 1.0 / k, dtype=h.dtype, device=h.device)
    return torch.sum(kld(h, q))


def total_entropy(lam: torch.Tensor, class_counts: torch.Tensor) -> torch.Tensor:
    """Sum of per-edge Shannon entropies chi_j (eq. 27)."""
    h = torch.clamp(edge_distributions(lam, class_counts), min=_EPS)
    return -torch.sum(h * torch.log(h))


def edge_pairs(n_edges: int):
    """The set S of unordered edge pairs used in eq. 29."""
    return list(itertools.combinations(range(n_edges), 2))


def pairwise_l1_objective(lam: torch.Tensor, class_counts: torch.Tensor) -> torch.Tensor:
    """Surrogate objective of P2 (eq. 29-30):
    sum_k sum_{(j,j') in S} | sum_i lam_ij c_k^i - sum_i lam_ij' c_k^i |."""
    counts = edge_class_counts(lam, class_counts)  # (N, K)
    idx = torch.as_tensor(edge_pairs(counts.shape[0]), dtype=torch.int64, device=counts.device)
    idx = idx.reshape(-1, 2)
    diff = counts[idx[:, 0]] - counts[idx[:, 1]]  # (P, K)
    return torch.sum(torch.abs(diff))


def divergence_bound(lam: torch.Tensor, class_counts: torch.Tensor) -> torch.Tensor:
    """Weight-divergence bound of eq. 17 (up to its constant):
    sum_j sigma_j * || H_j - p_global ||_1."""
    counts = edge_class_counts(lam, class_counts)
    totals = counts.sum(dim=1)
    sigma = totals / torch.clamp(totals.sum(), min=_EPS)
    h = counts / torch.clamp(totals[:, None], min=_EPS)
    global_counts = class_counts.sum(dim=0)
    p_global = global_counts / torch.clamp(global_counts.sum(), min=_EPS)
    return torch.sum(sigma * torch.sum(torch.abs(h - p_global[None, :]), dim=1))
