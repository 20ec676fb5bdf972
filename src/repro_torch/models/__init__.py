from repro_torch.models.cnn1d import (
    HEARTBEAT_CNN,
    SEIZURE_CNN,
    CNNConfig,
    cnn_apply,
    cnn_apply_cohort,
    cnn_init,
)
from repro_torch.models.config import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
)
from repro_torch.models.transformer import (
    block_spec,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
)

__all__ = [
    "CNNConfig",
    "HEARTBEAT_CNN",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "RWKVConfig",
    "SEIZURE_CNN",
    "SSMConfig",
    "block_spec",
    "cnn_apply",
    "cnn_apply_cohort",
    "cnn_init",
    "decode_step",
    "encode",
    "forward",
    "init_cache",
    "init_params",
]
