"""Solvers for the relaxed assignment problem P2 (eq. 30-34).

* ``solve_lp_scipy`` — exact LP via ``scipy.optimize.linprog`` after the
  standard |x| <= t linearization of the pairwise-L1 objective; the oracle.
* ``solve_lp_eg``    — mirror-descent subgradient solver over the row
  simplexes, with autograd for the subgradient; runs on the device.  The
  latency/energy constraints (31)-(32) enter as per-pair feasibility masks.

Both return a fractional lambda (M, N) with rows on the simplex, supported
only on feasible (i, j) pairs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.kld import edge_pairs, pairwise_l1_objective
from repro_torch.device import resolve_device


def solve_lp_scipy(
    class_counts: np.ndarray,
    feasible: Optional[np.ndarray] = None,
    latency: Optional[np.ndarray] = None,
    energy: Optional[np.ndarray] = None,
    max_latency: Optional[float] = None,
    max_energy: Optional[float] = None,
) -> np.ndarray:
    """Exact LP solution of P2.

    Variables: lambda (M*N) and t (P*K) with
        minimize    sum(t)
        subject to  +A_pk . lambda - t_pk <= 0
                    -A_pk . lambda - t_pk <= 0
                    sum_j lambda_ij = 1                        (33)
                    0 <= lambda_ij <= 1 (0 where infeasible)   (34) + masks
                    sum_j lambda_ij L_ij <= T^m - T^c_i        (31)
                    sum_j lambda_ij E_ij <= E^m                (32)
    """
    from scipy import sparse
    from scipy.optimize import linprog

    cc = np.asarray(class_counts, dtype=np.float64)
    m, k = cc.shape
    if feasible is None:
        feasible = np.ones((m, latency.shape[1] if latency is not None else 0), bool)
    n = feasible.shape[1]
    pairs = edge_pairs(n)
    n_lam = m * n
    n_t = len(pairs) * k

    def lam_idx(i, j):
        return i * n + j

    c = np.concatenate([np.zeros(n_lam), np.ones(n_t)])
    rows, cols, vals = [], [], []
    b_ub = []
    r = 0
    for pi, (j, jp) in enumerate(pairs):
        for ki in range(k):
            t_col = n_lam + pi * k + ki
            # +(sum_i lam_ij c - sum_i lam_ijp c) - t <= 0, and its negation
            for i in range(m):
                if cc[i, ki] == 0.0:
                    continue
                rows += [r, r + 1, r, r + 1]
                cols += [lam_idx(i, j), lam_idx(i, j), lam_idx(i, jp), lam_idx(i, jp)]
                vals += [cc[i, ki], -cc[i, ki], -cc[i, ki], cc[i, ki]]
            rows += [r, r + 1]
            cols += [t_col, t_col]
            vals += [-1.0, -1.0]
            b_ub += [0.0, 0.0]
            r += 2
    for bound, limit in ((latency, max_latency), (energy, max_energy)):
        if bound is None or limit is None:
            continue
        for i in range(m):
            for j in range(n):
                rows.append(r)
                cols.append(lam_idx(i, j))
                vals.append(float(bound[i, j]))
            b_ub.append(float(limit))
            r += 1
    a_ub = sparse.coo_matrix((vals, (rows, cols)), shape=(r, n_lam + n_t))
    a_eq = sparse.coo_matrix(
        (np.ones(n_lam), (np.repeat(np.arange(m), n), np.arange(n_lam))), shape=(m, n_lam + n_t)
    )
    bounds = [(0.0, 1.0 if feasible[i, j] else 0.0) for i in range(m) for j in range(n)]
    bounds += [(0.0, None)] * n_t
    res = linprog(
        c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=np.ones(m), bounds=bounds, method="highs"
    )
    if not res.success:
        raise RuntimeError(f"LP failed: {res.message}")
    return res.x[:n_lam].reshape(m, n)


def solve_lp_eg(
    class_counts,
    feasible,
    n_steps: int = 2000,
    lr: float = 0.05,
    device="cuda",
) -> torch.Tensor:
    """Mirror descent on the product of row simplexes, in float32.

    lambda_i = softmax(logits_i + log feasible_i); subgradient steps on the
    logits minimize the (convex, piecewise-linear) eq. 29 objective, scaled
    by the total count; the running average of the iterates approaches the
    LP optimum, and the last iterate is returned instead when it scores
    better.  Step sizes are rounded to float32 as the reference's are.
    """
    dev = resolve_device(device)
    cc = torch.as_tensor(np.asarray(class_counts), dtype=torch.float32, device=dev)
    mask = torch.tensor(np.asarray(feasible, bool), device=dev)
    m = cc.shape[0]
    neg_inf = torch.where(mask, 0.0, -1e9)
    norm = torch.clamp(cc.sum(), min=1.0)

    def lam_of(logits):
        return torch.softmax(logits + neg_inf, dim=1)

    logits = torch.zeros(mask.shape, dtype=torch.float32, device=dev)
    acc = torch.zeros_like(logits)
    for t in range(n_steps):
        logits.requires_grad_(True)
        obj = pairwise_l1_objective(lam_of(logits), cc) / norm
        (g,) = torch.autograd.grad(obj, logits)
        step = float(np.float32(lr) / np.sqrt(np.float32(1.0) + np.float32(t)))
        with torch.no_grad():
            logits = logits.detach() - step * g * m
            acc += lam_of(logits)
    with torch.no_grad():
        lam_avg = acc / n_steps
        lam_last = lam_of(logits)
        better_last = pairwise_l1_objective(lam_last, cc) < pairwise_l1_objective(lam_avg, cc)
        lam = torch.where(better_last, lam_last, lam_avg)
        lam = lam * mask
        return lam / torch.clamp(lam.sum(dim=1, keepdim=True), min=1e-12)
