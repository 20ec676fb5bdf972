"""rwkv6-7b [ssm]: Finch — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — data-dependent decay linear attention.  [arXiv:2404.05892]

Attention-sharding aspects of any technique are n/a (no attention); the
hierarchical-FL assignment applies unchanged.  ``long_500k`` runs natively
(O(1) recurrent state per token).
"""
from repro_torch.models.config import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,  # = d_model / head_size
        n_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        rwkv=RWKVConfig(head_size=64),
        act="gelu",
        norm="layernorm",
        max_seq=1048576,
        source="arXiv:2404.05892",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=256,
        rwkv=RWKVConfig(head_size=32),
        act="gelu",
        norm="layernorm",
        max_seq=256,
        dtype="float32",
        source="arXiv:2404.05892",
    )
