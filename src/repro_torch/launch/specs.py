"""Input and plan specs for the dry run: meta tensors, no allocation.

The port of ``src/repro/launch/specs.py``.  ``plan(arch, shape)`` decides
whether a pair runs and what config changes it needs (the sliding-window
variant for dense long-context decode, the cache capacity, the skip
rules); the other functions give a pair's inputs as ``meta`` tensors of
the reference's shapes and dtypes (its ``ShapeDtypeStruct`` stand-ins).
The parameters come from ``init_params`` given ``SHAPES_ONLY`` in place
of a generator: it draws nothing and builds meta tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.models import init_cache, init_params
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.modules import SHAPES_ONLY

SKIPS: Dict[Tuple[str, str], str] = {
    (
        "whisper-tiny",
        "long_500k",
    ): "enc-dec full-attention decoder; 524k-token decode unrepresentable for this family",
}

# dense/vlm archs get a sliding-window VARIANT for long_500k
SW_VARIANT_FAMILIES = ("dense", "vlm")
SW_WINDOW = 4096


@dataclasses.dataclass
class Plan:
    arch: str
    shape: InputShape
    cfg: ModelConfig
    kind: str  # train | prefill | decode
    note: str = ""


def plan(arch: str, shape_name) -> Optional[Plan]:
    """The pair's plan (None: skipped).  ``shape_name`` names one of
    ``INPUT_SHAPES``, or is an ``InputShape`` of its own (the tests'
    smaller ones)."""
    shape = shape_name if isinstance(shape_name, InputShape) else INPUT_SHAPES[shape_name]
    shape_name = shape.name
    if (arch, shape_name) in SKIPS:
        return None
    cfg = get_config(arch)
    note = ""
    if shape.kind == "decode":
        cfg = dataclasses.replace(cfg, max_seq=shape.seq_len)
        if shape_name == "long_500k" and cfg.family in SW_VARIANT_FAMILIES and cfg.sliding_window is None:
            cfg = dataclasses.replace(cfg, sliding_window=SW_WINDOW)
            note = f"sliding-window variant (w={SW_WINDOW})"
    elif shape.kind in ("train", "prefill"):
        cfg = dataclasses.replace(cfg, max_seq=max(cfg.max_seq, shape.seq_len))
    return Plan(arch, shape, cfg, shape.kind, note)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = _meta((b, cfg.n_audio_frames, cfg.d_model), cfg.param_dtype)
    return batch


def param_shapes(cfg: ModelConfig):
    """``init_params``' tree as meta tensors (no draw, no allocation)."""
    return init_params(SHAPES_ONLY, cfg)


def cache_shapes(cfg: ModelConfig, shape: InputShape, params_sds=None):
    """``init_cache``'s tree as meta tensors; an encdec cache runs the
    encoder on meta parameters and frame embeddings for its cross K and V."""
    if cfg.family == "encdec":
        params = params_sds if params_sds is not None else param_shapes(cfg)
        enc = _meta((shape.global_batch, cfg.n_audio_frames, cfg.d_model), cfg.param_dtype)
        return init_cache(cfg, shape.global_batch, shape.seq_len, params=params, enc_embeds=enc, device="meta")
    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")


def decode_input_specs(cfg: ModelConfig, shape: InputShape):
    del cfg
    b = shape.global_batch
    return {"token": _meta((b, 1), torch.int32), "position": _meta((b,), torch.int32)}


def input_specs(arch: str, shape_name: str) -> Optional[Dict[str, Any]]:
    """Every meta input of a pair."""
    p = plan(arch, shape_name)
    if p is None:
        return None
    out: Dict[str, Any] = {"plan": p, "params": param_shapes(p.cfg)}
    if p.kind in ("train", "prefill"):
        out["batch"] = train_batch_specs(p.cfg, p.shape)
    else:
        out["cache"] = cache_shapes(p.cfg, p.shape, out["params"])
        out.update(decode_input_specs(p.cfg, p.shape))
    return out
