"""EU Assignment and Resource Allocation — the paper's Algorithm 1 (EARA).

Pipeline (Sec. 5.2):
  1. solve the LP relaxation P2 (``core.lp``) for fractional lambda;
  2. round — greedy KLD placement (SCA), plus a KLD-gated second edge
     (DCA, 5G dual connectivity + multicast);
  3. greedy per-edge bandwidth allocation: rank assigned EUs by importance
     (marginal KLD contribution), give each the least bandwidth meeting the
     latency constraint (20), stop when B_j^m is exhausted.

Baselines: ``dba_assignment`` (nearest edge) and ``random_assignment``.
The objectives are scored in float32 on the host, as the reference scores
them; only the LP runs on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.kld import pairwise_l1_objective, total_kld_uniform
from repro_torch.core.lp import solve_lp_eg, solve_lp_scipy
from repro_torch.wireless.channel import CostMatrices, WirelessParams


@dataclasses.dataclass
class AssignmentResult:
    lam: np.ndarray  # (M, N) binary (rows sum to 1 for SCA; up to 2 for DCA)
    lam_frac: Optional[np.ndarray]  # LP fractional solution (None for baselines)
    bandwidth: Optional[np.ndarray]  # (M, N) Hz allocated (0 if unassigned/starved)
    kld_total: float  # P1 objective at the rounded assignment
    objective_l1: float  # eq. 29 objective at the rounded assignment
    served: Optional[np.ndarray] = None  # (M,) EU received bandwidth

    @property
    def edges_of(self) -> list:
        return [list(np.nonzero(self.lam[i])[0]) for i in range(self.lam.shape[0])]


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _total_kld(lam, class_counts) -> float:
    return float(total_kld_uniform(_f32(lam), _f32(class_counts)))


# --------------------------------------------------------------------------
# rounding (Alg. 1 lines 4-15)
# --------------------------------------------------------------------------
def _kld_uniform(counts: np.ndarray) -> float:
    """float64 KLD to uniform of one edge's (K,) class-count vector."""
    k = counts.shape[0]
    h = np.maximum(counts / max(counts.sum(), 1e-12), 1e-12)
    return float(np.sum(h * (np.log(h) + np.log(k))))


def round_sca(lam_frac: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """eq. 35: lambda*_ij = 1 at argmax_j, 0 elsewhere (within feasible set)."""
    masked = np.where(feasible, lam_frac, -np.inf)
    lam = np.zeros_like(lam_frac)
    lam[np.arange(lam.shape[0]), masked.argmax(axis=1)] = 1.0
    return lam


def round_greedy_kld(
    lam_frac: np.ndarray, feasible: np.ndarray, class_counts: np.ndarray
) -> np.ndarray:
    """Greedy KLD rounding used by ``eara()`` (beyond the paper).

    The LP relaxation is degenerate (a uniform split equalizes every edge),
    so argmax rounding of it is essentially arbitrary.  Instead EUs are
    placed, largest datasets first, on the feasible edge that minimizes the
    exact P1 objective of the partial assignment, with the LP mass as a
    tie-break; each still-empty edge is charged the maximum divergence
    log(K) so the greedy never collapses onto one edge.
    """
    m, n = lam_frac.shape
    cc = np.asarray(class_counts, np.float64)
    empty_penalty = np.log(cc.shape[1])
    edge_counts = np.zeros((n, cc.shape[1]))
    edge_kld = np.array([_kld_uniform(edge_counts[j]) for j in range(n)])
    n_assigned = np.zeros(n, np.int64)
    lam = np.zeros_like(lam_frac)
    order = np.argsort(-cc.sum(axis=1), kind="stable")
    for i in order:
        best_j, best_val, best_kld = None, np.inf, 0.0
        for j in range(n):
            if not feasible[i, j]:
                continue
            kld_j = _kld_uniform(edge_counts[j] + cc[i])
            empties = int((n_assigned == 0).sum()) - (1 if n_assigned[j] == 0 else 0)
            val = (
                edge_kld.sum() - edge_kld[j] + kld_j
                + empty_penalty * empties
                - 1e-9 * lam_frac[i, j]
            )
            if val < best_val - 1e-12:
                best_val, best_j, best_kld = val, j, kld_j
        if best_j is None:  # no feasible edge: row stays unassigned
            continue
        lam[i, best_j] = 1.0
        edge_counts[best_j] += cc[i]
        edge_kld[best_j] = best_kld
        n_assigned[best_j] += 1
    return lam


def round_dca(lam_frac: np.ndarray, feasible: np.ndarray, nu: float = 0.3) -> np.ndarray:
    """Top-1 always; top-2 additionally iff lambda^2_ij > nu (Alg. 1 l. 7-15)."""
    masked = np.where(feasible, lam_frac, -np.inf)
    order = np.argsort(-masked, axis=1)
    lam = np.zeros_like(lam_frac)
    rows = np.arange(lam.shape[0])
    lam[rows, order[:, 0]] = 1.0
    if lam_frac.shape[1] > 1:
        second = order[:, 1]
        val2 = masked[rows, second]
        take = (val2 > nu) & np.isfinite(val2)
        lam[rows[take], second[take]] = 1.0
    return lam


# --------------------------------------------------------------------------
# importance + bandwidth allocation (Alg. 1 lines 18-26)
# --------------------------------------------------------------------------
def eu_importance(lam: np.ndarray, class_counts: np.ndarray) -> np.ndarray:
    """Importance of each assigned EU = the KLD increase if it were dropped."""
    base = _total_kld(lam, class_counts)
    imp = np.zeros(lam.shape[0])
    for i in range(lam.shape[0]):
        if lam[i].sum() == 0:
            continue
        drop = lam.copy()
        drop[i] = 0.0
        imp[i] = _total_kld(drop, class_counts) - base
    return imp


def min_bandwidth_for_latency(
    bits: float, gain: float, p_tx: float, compute_time: float, p: WirelessParams, tol: float = 1e-3
) -> float:
    """Smallest B such that bits/rate(B) + xi + T_c <= T^m (bisection; the
    latency decreases in B)."""
    budget = p.max_latency - p.xi_access_delay - compute_time
    if budget <= 0:
        return float("inf")

    def latency(b):
        rate = b * np.log2(1.0 + p_tx * gain / (p.noise_density * b))
        return bits / max(rate, 1e-9)

    lo, hi = 1e3, p.bandwidth_total
    if latency(hi) > budget:
        return float("inf")
    while hi / lo > 1 + tol:
        mid = np.sqrt(lo * hi)
        if latency(mid) <= budget:
            hi = mid
        else:
            lo = mid
    return hi


def allocate_bandwidth(
    lam: np.ndarray,
    class_counts: np.ndarray,
    cost: CostMatrices,
    topo_tx_power: np.ndarray,
    p: WirelessParams,
    model_bits: float,
) -> tuple:
    """Greedy per-edge allocation (Alg. 1, at-the-edge phase).
    Returns (bandwidth (M, N), served (M,) bool)."""
    m, n = lam.shape
    bw = np.zeros((m, n))
    served = np.zeros(m, bool)
    imp = eu_importance(lam, class_counts)
    for j in range(n):
        members = np.nonzero(lam[:, j])[0]
        if len(members) == 0:
            continue
        order = members[np.argsort(-imp[members])]  # descending importance
        budget = p.bandwidth_total
        for i in order:
            need = min_bandwidth_for_latency(
                model_bits,
                float(cost.gain[i, j]),
                float(topo_tx_power[i]),
                float(cost.compute_time[i]),
                p,
            )
            if not np.isfinite(need) or need > budget:
                continue  # starved: EU keeps assignment but no allocation
            bw[i, j] = need
            served[i] = True
            budget -= need
            if budget <= 0:
                break
    return bw, served


def local_search_refine(
    lam: np.ndarray, class_counts: np.ndarray, feasible: np.ndarray, max_rounds: int = 20
) -> np.ndarray:
    """1-move local search on the rounded assignment (beyond the paper):
    relocate single-connectivity EUs while a move lowers the exact P1
    objective."""
    lam = lam.copy()
    m, n = lam.shape
    best = _total_kld(lam, class_counts)
    for _ in range(max_rounds):
        improved = False
        for i in range(m):
            cur = np.nonzero(lam[i])[0]
            if len(cur) != 1:
                continue  # only refine single-connectivity rows
            for j in range(n):
                if j == cur[0] or not feasible[i, j]:
                    continue
                trial = lam.copy()
                trial[i, cur[0]] = 0.0
                trial[i, j] = 1.0
                s = _total_kld(trial, class_counts)
                if s < best - 1e-9:
                    lam, best, improved = trial, s, True
        if not improved:
            break
    return lam


# --------------------------------------------------------------------------
# full EARA (Alg. 1) + baselines
# --------------------------------------------------------------------------
def _finish(lam, lam_frac, class_counts, bw=None, served=None) -> AssignmentResult:
    return AssignmentResult(
        lam=np.asarray(lam),
        lam_frac=None if lam_frac is None else np.asarray(lam_frac),
        bandwidth=bw,
        kld_total=_total_kld(lam, class_counts),
        objective_l1=float(pairwise_l1_objective(_f32(lam), _f32(class_counts))),
        served=served,
    )


def eara(
    class_counts: np.ndarray,
    cost: CostMatrices,
    p: WirelessParams,
    model_bits: float,
    topo_tx_power: np.ndarray,
    mode: str = "sca",
    nu: float = 0.3,
    solver: str = "eg",
    allocate: bool = True,
    refine: bool = False,
    device="cuda",
) -> AssignmentResult:
    """Algorithm 1 end to end; ``refine=True`` adds the local-search pass.
    ``device`` is where the ``"eg"`` LP solver runs."""
    feasible = cost.feasible
    if solver == "scipy":
        lam_frac = solve_lp_scipy(class_counts, feasible)
    else:
        lam_frac = solve_lp_eg(class_counts, feasible, device=device).cpu().numpy()
    if mode not in ("sca", "dca"):
        raise ValueError(f"unknown EARA mode {mode!r}")
    lam = round_greedy_kld(lam_frac, feasible, class_counts)
    if mode == "dca" and lam.shape[1] > 1:
        # the lam_frac-thresholded secondary edge, accepted only when it
        # lowers the exact P1 objective by a strict margin (the LP is
        # degenerate, so a thresholded secondary can worsen the balance);
        # rows in index order on a running assignment
        masked = np.where(feasible, lam_frac, -np.inf)
        cc = np.asarray(class_counts, np.float64)
        edge_counts = lam.T @ cc  # (N, K)
        edge_kld = np.array([_kld_uniform(edge_counts[j]) for j in range(lam.shape[1])])
        for i in range(lam.shape[0]):
            primary = np.nonzero(lam[i])[0]
            if len(primary) != 1:
                continue
            cand = masked[i].copy()
            cand[primary[0]] = -np.inf
            second = int(cand.argmax())
            if not (np.isfinite(cand[second]) and cand[second] > nu):
                continue
            kld_trial = _kld_uniform(edge_counts[second] + cc[i])
            # a 1e-6 margin keeps DCA <= SCA true in the float32 scoring too
            if kld_trial <= edge_kld[second] - 1e-6:
                lam[i, second] = 1.0
                edge_counts[second] += cc[i]
                edge_kld[second] = kld_trial
    if refine:
        lam = local_search_refine(lam, class_counts, feasible)
    bw = served = None
    if allocate:
        bw, served = allocate_bandwidth(lam, class_counts, cost, topo_tx_power, p, model_bits)
    return _finish(lam, lam_frac, class_counts, bw, served)


def dba_assignment(class_counts: np.ndarray, dist: np.ndarray) -> AssignmentResult:
    """Distance-Based Allocation: every EU to its nearest edge node."""
    m, n = dist.shape
    lam = np.zeros((m, n))
    lam[np.arange(m), dist.argmin(axis=1)] = 1.0
    return _finish(lam, None, class_counts)


def random_assignment(class_counts: np.ndarray, n_edges: int, seed: int = 0) -> AssignmentResult:
    rng = np.random.default_rng(seed)
    m = class_counts.shape[0]
    lam = np.zeros((m, n_edges))
    lam[np.arange(m), rng.integers(0, n_edges, m)] = 1.0
    return _finish(lam, None, class_counts)
