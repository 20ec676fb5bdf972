from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import (
    PROGRAMS,
    ClientProgram,
    CNNProgram,
    FedSGDProgram,
    MLPProgram,
    as_program,
    group_clients,
    group_edge_sizes,
)
from repro_torch.federated.scenario import Scenario, build_scenario
from repro_torch.federated.simulation import (
    HFLSimulation,
    RoundMetrics,
    SimResult,
    centralized_baseline,
    evaluate,
)

__all__ = [
    "CNNProgram",
    "ClientProgram",
    "FLClient",
    "FedSGDProgram",
    "HFLSimulation",
    "MLPProgram",
    "PROGRAMS",
    "RoundMetrics",
    "Scenario",
    "SimResult",
    "as_program",
    "build_scenario",
    "centralized_baseline",
    "evaluate",
    "group_clients",
    "group_edge_sizes",
]
