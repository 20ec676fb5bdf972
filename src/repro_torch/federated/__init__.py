from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import (
    PROGRAMS,
    SEQUENCE_PROGRAMS,
    ClientProgram,
    CNNProgram,
    FedSGDProgram,
    LMProgram,
    MLPProgram,
    SequenceProgram,
    as_program,
    group_clients,
    group_edge_sizes,
    tiny_lm_config,
)
from repro_torch.federated.sampling import CohortSpec, pareto_weights
from repro_torch.federated.scenario import Scenario, build_scenario
from repro_torch.federated.simulation import (
    HeteroHFLSimulation,
    HFLSimulation,
    RoundMetrics,
    SimResult,
    centralized_baseline,
    evaluate,
)
from repro_torch.federated.stream import (
    LazyClientList,
    StreamScenario,
    build_stream_scenario,
    edge_kld_uniform,
    striped_assignment,
)

__all__ = [
    "CNNProgram",
    "ClientProgram",
    "CohortSpec",
    "FLClient",
    "FedSGDProgram",
    "HFLSimulation",
    "HeteroHFLSimulation",
    "LMProgram",
    "LazyClientList",
    "MLPProgram",
    "PROGRAMS",
    "RoundMetrics",
    "SEQUENCE_PROGRAMS",
    "Scenario",
    "SequenceProgram",
    "SimResult",
    "StreamScenario",
    "as_program",
    "build_scenario",
    "build_stream_scenario",
    "centralized_baseline",
    "edge_kld_uniform",
    "evaluate",
    "group_clients",
    "group_edge_sizes",
    "pareto_weights",
    "striped_assignment",
    "tiny_lm_config",
]
