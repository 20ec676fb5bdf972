from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import (
    ClientProgram,
    CNNProgram,
    as_program,
    group_clients,
    group_edge_sizes,
)
from repro_torch.federated.scenario import Scenario, build_scenario
from repro_torch.federated.simulation import RoundMetrics, SimResult, evaluate

__all__ = [
    "CNNProgram",
    "ClientProgram",
    "FLClient",
    "RoundMetrics",
    "Scenario",
    "SimResult",
    "as_program",
    "build_scenario",
    "evaluate",
    "group_clients",
    "group_edge_sizes",
]
