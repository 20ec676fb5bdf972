"""Wireless communication / computation cost model (paper Sec. 4.2-4.3).

Implements eq. 10-16 in float32, as the reference does:

  gain      g_ij = theta * omega * d_ij^-alpha * |h_ij|^2        (15)
  SNR       gamma_ij = P^r / (N0 * B)                            (12)
  rate      r_ij = B_ij log2(1 + theta*gamma_ij)                 (13)
  power     P^t  = N0 B / g * (2^{r/B} - 1)                      (14)
  energy    E_ij = |W| N0 B / (r g) * (2^{r/B} - 1)              (16)
  latency   L_ij = |W| / r_ij + xi                               (10)
  compute   T_i^c = v log(1/eps) * psi_i * D_i / f_i             (Sec. 4.2)

``build_cost_matrices`` evaluates the (M, N) matrices that EARA's
constraints (20)-(21) read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WirelessParams:
    """Physical-layer constants (defaults chosen to match the paper's regime)."""

    noise_density: float = 1e-20  # N0, W/Hz (approx -170 dBm/Hz)
    path_loss_exp: float = 3.0  # alpha in [2, 6]
    omega: float = 1e-3  # antenna/wavelength constant
    ber: float = 1e-4  # bit error rate target
    bandwidth_total: float = 20e6  # B_j^m per edge node, Hz
    default_bandwidth: float = 1e6  # B_f equal-share starting point, Hz
    xi_access_delay: float = 5e-3  # xi, access channel delay, s
    max_latency: float = 1.0  # T^m, s
    max_energy: float = 1.0  # E_i^m, J
    cpu_cycles_per_sample: float = 1e4  # psi_i
    local_accuracy: float = 0.1  # eps
    v_constant: float = 1.0  # v in T_i^c

    @property
    def theta(self) -> float:
        """BER gap: theta = -1.5 / log(5 * BER)   (after eq. 13)."""
        return -1.5 / np.log(5.0 * self.ber)


def channel_gain(dist: torch.Tensor, fading_mag2: torch.Tensor, p: WirelessParams):
    """g_ij (eq. 15) with theta folded in as in the paper."""
    return p.theta * p.omega * torch.pow(torch.clamp(dist, min=1.0), -p.path_loss_exp) * fading_mag2


def snr(p_tx, gain, bandwidth, p: WirelessParams):
    """gamma_ij (eq. 12) folded with the gain: theta*gamma = P^t g / (N0 B)."""
    return p_tx * gain / (p.noise_density * torch.clamp(bandwidth, min=1.0))


def shannon_rate(p_tx, gain, bandwidth, p: WirelessParams):
    """r_ij (eq. 13): B log2(1 + theta*gamma) with theta already inside gain."""
    return bandwidth * torch.log2(1.0 + snr(p_tx, gain, bandwidth, p))


def tx_power(rate, gain, bandwidth, p: WirelessParams):
    """P^t_ij (eq. 14) needed to sustain ``rate`` over ``bandwidth``."""
    return (
        p.noise_density
        * bandwidth
        / torch.clamp(gain, min=1e-30)
        * (torch.exp2(rate / torch.clamp(bandwidth, min=1.0)) - 1.0)
    )


def tx_energy(bits, rate, gain, bandwidth, p: WirelessParams):
    """E_ij (eq. 16): energy to push ``bits`` at ``rate``."""
    return tx_power(rate, gain, bandwidth, p) * bits / torch.clamp(rate, min=1.0)


def uplink_latency(bits, rate, p: WirelessParams):
    """L_ij (eq. 10, per-EU term): transmission + access delay."""
    return bits / torch.clamp(rate, min=1.0) + p.xi_access_delay


def computation_time(dataset_size, cpu_freq, p: WirelessParams):
    """T_i^c (Sec. 4.2): v * log(1/eps) * psi_i * D_i / f_i."""
    iters = p.v_constant * np.log(1.0 / p.local_accuracy)
    return iters * p.cpu_cycles_per_sample * dataset_size / cpu_freq


@dataclasses.dataclass
class Topology:
    """Sampled geometry + EU hardware for one experiment instance."""

    dist: np.ndarray  # (M, N) EU-to-edge distances, m
    fading_mag2: np.ndarray  # (M, N) |h_ij|^2 Rayleigh fading power
    cpu_freq: np.ndarray  # (M,) f_i, Hz
    tx_power_max: np.ndarray  # (M,) transmit power budget, W
    dataset_size: np.ndarray  # (M,) D_i samples


def sample_topology(
    generator: torch.Generator,
    n_eus: int,
    n_edges: int,
    *,
    area_m: float = 1000.0,
    mean_dist: Optional[float] = None,
    dataset_sizes: Optional[np.ndarray] = None,
) -> Topology:
    """EU/edge positions uniform in a square cell of side ``area_m``,
    Rayleigh fading, heterogeneous CPU frequencies; drawn in float32 on the
    CPU from ``generator`` (the reference draws from ``jax.random``, which
    cannot be repeated here).  ``mean_dist`` rescales the distances."""

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float32)

    eu_pos = uniform(n_eus, 2) * area_m
    edge_pos = uniform(n_edges, 2) * area_m
    dist = torch.linalg.norm(eu_pos[:, None, :] - edge_pos[None, :, :], dim=-1).numpy()
    if mean_dist is not None:
        dist = dist * (mean_dist / max(dist.mean(), 1e-9))
    # Rayleigh fading magnitude via inverse-transform sampling (unit scale)
    u = 1e-6 + (1.0 - 1e-6) * uniform(n_eus, n_edges)
    ray = torch.sqrt(-2.0 * torch.log(u)) / np.sqrt(2.0)
    fading = torch.square(ray).numpy()
    cpu = (10 ** (8.0 + 1.5 * uniform(n_eus))).numpy()
    if dataset_sizes is None:
        dataset_sizes = np.full((n_eus,), 1000)
    return Topology(
        dist=dist,
        fading_mag2=fading,
        cpu_freq=cpu,
        tx_power_max=np.full((n_eus,), 0.2),
        dataset_size=np.asarray(dataset_sizes),
    )


@dataclasses.dataclass
class CostMatrices:
    """Everything the EARA LP needs about the physical layer."""

    latency: np.ndarray  # (M, N) L_ij + T_i^c, s
    energy: np.ndarray  # (M, N) E_ij, J
    rate: np.ndarray  # (M, N) r^u_ij at default bandwidth, bit/s
    gain: np.ndarray  # (M, N) g_ij
    compute_time: np.ndarray  # (M,) T_i^c
    feasible: np.ndarray  # (M, N) bool: constraints (20) & (21) satisfiable


def build_cost_matrices(
    topo: Topology, model_bits: float, p: WirelessParams, device="cuda"
) -> CostMatrices:
    """Evaluate L_ij, E_ij at the equal-share bandwidth B_f (Alg. 1 input)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    b = torch.full(topo.dist.shape, p.default_bandwidth, dtype=torch.float32, device=dev)
    gain = channel_gain(f32(topo.dist), f32(topo.fading_mag2), p)
    rate = shannon_rate(f32(topo.tx_power_max)[:, None], gain, b, p)
    lat = uplink_latency(model_bits, rate, p)
    en = tx_energy(model_bits, rate, gain, b, p)
    tcomp = computation_time(f32(topo.dataset_size), f32(topo.cpu_freq), p)
    total_lat = lat + tcomp[:, None]
    feas = (total_lat <= p.max_latency) & (en <= p.max_energy)
    # never leave an EU with zero feasible edges: fall back to its best edge
    # (the paper implicitly assumes at least the nearest edge is reachable)
    best = torch.argmin(total_lat + 1e3 * en, dim=1)
    fallback = torch.nn.functional.one_hot(best, topo.dist.shape[1]).to(torch.bool)
    feas = torch.where(feas.any(dim=1, keepdim=True), feas, fallback)

    def host(t):
        return t.cpu().numpy()

    return CostMatrices(
        latency=host(total_lat),
        energy=host(en),
        rate=host(rate),
        gain=host(gain),
        compute_time=host(tcomp),
        feasible=host(feas),
    )


def feasibility(cost: CostMatrices, p: WirelessParams) -> np.ndarray:
    """(M, N) mask of pairs satisfying latency (20) and energy (21)."""
    return cost.feasible
