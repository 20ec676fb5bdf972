"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2 — Mamba+attention 1:7 interleave.
[arXiv:2403.19887]

Block structure: every 8 layers = 1 attention + 7 mamba; MoE replaces the
dense MLP on every second layer (offset 1).  ``long_500k`` runs natively:
mamba layers carry O(1) state and the (few) attention layers use their
full KV cache sharded over the sequence axis (context parallel).
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        hybrid_block=8,
        moe=MoEConfig(n_experts=16, top_k=2, every=2, offset=1),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        act="swiglu",
        norm="rmsnorm",
        max_seq=262144,
        source="arXiv:2403.19887",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke",
        family="hybrid",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        hybrid_block=2,
        moe=MoEConfig(n_experts=4, top_k=2, every=2, offset=1),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
        act="swiglu",
        norm="rmsnorm",
        max_seq=128,
        dtype="float32",
        source="arXiv:2403.19887",
    )
