"""Functional module primitives (init + apply pairs) for the sequence models.

Parameters are plain nested dicts of tensors keyed as in the reference
(``src/repro/models/modules.py``); every ``*_init`` returns a dict and the
matching apply is a plain function.  Initial draws come from an explicit
``torch.Generator``, on the generator's device; they are not the
reference's ``jax.random`` draws, so parity tests carry the reference's
parameters across (``repro_torch.convert``).

Matrix products follow the reference's numerics: products accumulate in
fp32 and are cast back to the input dtype (``dense``); the output logits
stay in fp32 (``unembed``).  The reference's ``_matmul`` custom VJP serves
training only; the forward here is a plain product.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """fp32 standard normal draws times ``scale``, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *, bias: bool = False, scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w (fp32 accumulation, in x's dtype), plus the bias added in fp32."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = (y.float() + p["b"].float()).to(x.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return {"emb": _normal(gen, (vocab, d), 0.02, dtype)}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    return p["emb"][ids]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied or untied output projection to vocab logits, in fp32.

    The logits are accumulated and returned in fp32 whatever the weights'
    dtype (the reference's ``preferred_element_type=f32``): a bf16 product
    would round them to bf16 before the argmax.  On the card a bf16 weight
    goes to one product with an fp32 output (``torch.mm(..., out_dtype=)``)
    rather than an fp32 copy of the (V, d) matrix; the CPU, which lacks
    that product, upcasts.
    """
    emb = p["emb"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == emb.dtype == torch.float32:
        out = torch.mm(x2, emb.t())
    elif x2.is_cuda and x2.dtype == emb.dtype:
        out = torch.mm(x2, emb.t(), out_dtype=torch.float32)
    else:
        out = torch.mm(x2.float(), emb.float().t())
    return out.reshape(*lead, emb.shape[0])


def norm_init(d: int, dtype, kind: str = "rmsnorm", device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (``scale`` only) or LayerNorm (``scale`` and ``bias``),
    computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# rotary position embeddings -------------------------------------------------
def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


@functools.lru_cache(maxsize=None)
def _device_frequencies(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    """The frequencies on ``device``, copied there once: a copy from host
    memory on every call would make the host wait for the card each time."""
    return torch.from_numpy(rope_frequencies(d_head, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: broadcastable to (..., seq).

    Split-half rotation (the first and second halves of d_head pair up),
    not interleaved, in fp32, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = _device_frequencies(d, theta, x.device)  # (d/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, d/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
