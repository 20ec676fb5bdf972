"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 (fine-grained experts: d_ff=512 each).
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        moe=MoEConfig(n_experts=40, top_k=8, every=1),
        act="swiglu",
        norm="rmsnorm",
        max_seq=4096,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=4,
        d_ff=64,
        vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2, every=1),
        act="swiglu",
        norm="rmsnorm",
        max_seq=128,
        dtype="float32",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
