"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk-norm, GQA.  [hf:Qwen/Qwen3-8B]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        act="swiglu",
        norm="rmsnorm",
        max_seq=32768,
        source="hf:Qwen/Qwen3-8B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        qk_norm=True,
        act="swiglu",
        norm="rmsnorm",
        max_seq=128,
        dtype="float32",
        source="hf:Qwen/Qwen3-8B",
    )
