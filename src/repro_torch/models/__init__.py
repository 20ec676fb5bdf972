from repro_torch.models.cnn1d import (
    HEARTBEAT_CNN,
    SEIZURE_CNN,
    CNNConfig,
    cnn_apply,
    cnn_apply_cohort,
    cnn_init,
)

__all__ = [
    "CNNConfig",
    "HEARTBEAT_CNN",
    "SEIZURE_CNN",
    "cnn_apply",
    "cnn_apply_cohort",
    "cnn_init",
]
