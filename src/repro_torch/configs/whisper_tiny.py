"""whisper-tiny [audio]: encoder-decoder transformer backbone.

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865 — conv/mel frontend is a
stub (input_specs provides precomputed frame embeddings).  [arXiv:2212.04356]

Adaptation notes: original whisper uses sinusoidal/learned absolute position
embeddings; we use RoPE in self-attention (TPU-idiomatic, shared code path) —
noted in DESIGN.md.  GQA kv=6 == MHA here.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,
        n_encoder_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        n_audio_frames=1500,
        max_seq=448,
        source="arXiv:2212.04356",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke",
        family="encdec",
        n_layers=2,
        n_encoder_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=256,
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        n_audio_frames=16,
        max_seq=64,
        dtype="float32",
        source="arXiv:2212.04356",
    )
