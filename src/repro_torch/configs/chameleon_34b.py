"""chameleon-34b [vlm]: early-fusion, VQ image tokens in the shared vocab.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  [arXiv:2405.09818]

The vision frontend (VQ tokenizer) is a stub — image patches arrive as
ordinary token ids inside the 65536 vocabulary (early fusion).  Chameleon
uses qk-norm for training stability; reproduced here.  ``long_500k`` runs
with the sliding-window attention *variant* (not in the original model —
noted in DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        qk_norm=True,
        act="swiglu",
        norm="rmsnorm",
        n_patch_tokens=1024,
        max_seq=4096,
        source="arXiv:2405.09818",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        qk_norm=True,
        act="swiglu",
        norm="rmsnorm",
        n_patch_tokens=16,
        max_seq=128,
        dtype="float32",
        source="arXiv:2405.09818",
    )
