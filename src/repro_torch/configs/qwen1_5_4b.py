"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
        act="swiglu",
        norm="rmsnorm",
        max_seq=32768,
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=256,
        qkv_bias=True,
        act="swiglu",
        norm="rmsnorm",
        max_seq=128,
        dtype="float32",
        source="hf:Qwen/Qwen1.5-0.5B",
    )
