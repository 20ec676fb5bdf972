"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full published configuration;
``get_smoke_config(name)`` returns the reduced same-family variant used by
CPU smoke tests (<=2 layers, d_model <= 512, <= 4 experts).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

ARCH_NAMES = [
    "whisper_tiny",
    "dbrx_132b",
    "chameleon_34b",
    "starcoder2_3b",
    "phi3_mini_3_8b",
    "qwen1_5_4b",
    "granite_moe_3b_a800m",
    "jamba_1_5_large_398b",
    "qwen3_14b",
    "rwkv6_7b",
]

# user-facing ids (--arch) -> module names
ARCH_IDS = {
    "whisper-tiny": "whisper_tiny",
    "dbrx-132b": "dbrx_132b",
    "chameleon-34b": "chameleon_34b",
    "starcoder2-3b": "starcoder2_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen3-14b": "qwen3_14b",
    "rwkv6-7b": "rwkv6_7b",
}


def _module(name: str):
    mod = ARCH_IDS.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config().validate()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config().validate()


def list_archs():
    return sorted(ARCH_IDS)


__all__ = [
    "ARCH_IDS",
    "ARCH_NAMES",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
