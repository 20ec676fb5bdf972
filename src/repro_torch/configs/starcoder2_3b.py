"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, native sliding window 4096.  [arXiv:2402.19173]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        sliding_window=4096,
        rope_theta=999999.0,
        max_seq=16384,
        source="arXiv:2402.19173",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        sliding_window=32,
        max_seq=128,
        dtype="float32",
        source="arXiv:2402.19173",
    )
