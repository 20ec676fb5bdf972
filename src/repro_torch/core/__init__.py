"""The paper's primary contribution: KLD-optimal hierarchical FL assignment."""
from repro_torch.core.assignment import (
    AssignmentResult,
    allocate_bandwidth,
    dba_assignment,
    eara,
    eu_importance,
    local_search_refine,
    min_bandwidth_for_latency,
    random_assignment,
    round_dca,
    round_greedy_kld,
    round_sca,
)
from repro_torch.core.hfl import CommAccountant, HFLSchedule, WallClock
from repro_torch.core.kld import (
    divergence_bound,
    edge_class_counts,
    edge_distributions,
    edge_pairs,
    kld,
    pairwise_l1_objective,
    total_entropy,
    total_kld_uniform,
)
from repro_torch.core.lp import solve_lp_eg, solve_lp_scipy

__all__ = [
    "AssignmentResult",
    "CommAccountant",
    "HFLSchedule",
    "WallClock",
    "allocate_bandwidth",
    "dba_assignment",
    "divergence_bound",
    "eara",
    "edge_class_counts",
    "edge_distributions",
    "edge_pairs",
    "eu_importance",
    "kld",
    "local_search_refine",
    "min_bandwidth_for_latency",
    "pairwise_l1_objective",
    "random_assignment",
    "round_dca",
    "round_greedy_kld",
    "round_sca",
    "solve_lp_eg",
    "solve_lp_scipy",
    "total_entropy",
    "total_kld_uniform",
]
