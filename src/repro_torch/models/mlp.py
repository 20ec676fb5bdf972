"""Feed-forward blocks: GeLU MLP and SwiGLU (gated) MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import dense, dense_init


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None):
    dt = cfg.param_dtype
    d_ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi": dense_init(gen, cfg.d_model, d_ff, dt),
            "wg": dense_init(gen, cfg.d_model, d_ff, dt),
            "wo": dense_init(gen, d_ff, cfg.d_model, dt),
        }
    return {
        "wi": dense_init(gen, cfg.d_model, d_ff, dt),
        "wo": dense_init(gen, d_ff, cfg.d_model, dt),
    }


def mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if "wg" in p:
        h = F.silu(dense(p["wi"], x).float()).to(x.dtype)
        h = h * dense(p["wg"], x)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["wi"], x).float(), approximate="tanh").to(x.dtype)
    return dense(p["wo"], h)
