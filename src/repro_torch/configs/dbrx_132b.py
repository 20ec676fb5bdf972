"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base]
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        moe=MoEConfig(n_experts=16, top_k=4, every=1),
        rope_theta=500000.0,
        act="swiglu",
        norm="rmsnorm",
        max_seq=32768,
        source="hf:databricks/dbrx-base",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2, every=1),
        rope_theta=500000.0,
        act="swiglu",
        norm="rmsnorm",
        max_seq=128,
        dtype="float32",
        source="hf:databricks/dbrx-base",
    )
