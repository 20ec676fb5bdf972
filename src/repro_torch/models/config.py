"""Architecture configuration schema covering all 10 assigned architectures.

One ``ModelConfig`` describes any member of the supported families:
dense / moe / hybrid (mamba+attn) / ssm (rwkv6) / encdec (whisper) / vlm.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    # which decoder layers are MoE: every `every`-th layer starting at `offset`
    every: int = 1
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba (S6) settings for hybrid archs."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation (arXiv / model card)

    # attention options
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # static window if set
    use_flash: bool = False  # route through the Pallas kernel (TPU)

    # MLP
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # hybrid (jamba): within each block of `hybrid_block` layers, layer 0 is
    # attention and the rest are mamba. n_layers % hybrid_block == 0.
    hybrid_block: int = 0

    # encoder-decoder (whisper): n_layers is the decoder depth.
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500  # encoder sequence length (stub frontend)

    # vlm: number of prefix patch embeddings handed in by the stub frontend
    n_patch_tokens: int = 0

    max_seq: int = 8192
    remat: bool = False  # per-block activation rematerialization (training)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def param_dtype(self):
        return getattr(torch, self.dtype)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer sequence of 'attn' | 'mamba' | 'rwkv' mixer kinds."""
        if self.family == "ssm":
            return tuple("rwkv" for _ in range(self.n_layers))
        if self.family == "hybrid":
            assert self.hybrid_block > 0 and self.n_layers % self.hybrid_block == 0
            kinds = []
            for l in range(self.n_layers):
                kinds.append("attn" if l % self.hybrid_block == 0 else "mamba")
            return tuple(kinds)
        return tuple("attn" for _ in range(self.n_layers))

    def is_moe_layer(self, layer: int) -> bool:
        if self.moe is None or self.moe.n_experts == 0:
            return False
        return layer % self.moe.every == self.moe.offset

    def validate(self) -> "ModelConfig":
        assert self.n_heads % self.n_kv_heads == 0, "GQA requires kv | heads"
        assert self.family in ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")
        if self.family == "hybrid":
            assert self.ssm is not None and self.hybrid_block > 0
        if self.family == "ssm":
            assert self.rwkv is not None
        if self.family == "moe":
            assert self.moe is not None and self.moe.n_experts > 0
        if self.family == "encdec":
            assert self.n_encoder_layers > 0
        return self


# the four assigned input shapes ------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
