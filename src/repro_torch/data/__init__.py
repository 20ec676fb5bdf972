from repro_torch.data.partition import (
    TABLE2_SEIZURE,
    TABLE3_HEARTBEAT,
    class_histogram,
    dirichlet_partition,
    eu_counts_from_edge_table,
    split_dataset_by_counts,
)
from repro_torch.data.synthetic_health import Dataset, heartbeat_like, make_dataset, seizure_like

__all__ = [
    "Dataset",
    "TABLE2_SEIZURE",
    "TABLE3_HEARTBEAT",
    "class_histogram",
    "dirichlet_partition",
    "eu_counts_from_edge_table",
    "heartbeat_like",
    "make_dataset",
    "seizure_like",
    "split_dataset_by_counts",
]
