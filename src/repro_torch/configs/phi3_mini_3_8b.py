"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE, SwiGLU.  kv=32 == MHA.  [arXiv:2404.14219]

``long_500k`` uses the sliding-window variant (phi3's blocksparse attention
has no direct TPU analogue; SW-4k is our TPU-idiomatic stand-in, DESIGN.md).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        act="swiglu",
        norm="rmsnorm",
        max_seq=4096,
        source="arXiv:2404.14219",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=8,
        d_ff=256,
        vocab_size=256,
        act="swiglu",
        norm="rmsnorm",
        max_seq=128,
        dtype="float32",
        source="arXiv:2404.14219",
    )
