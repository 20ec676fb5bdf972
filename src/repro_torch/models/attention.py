"""Grouped-query attention with RoPE, qk-norm, QKV bias, sliding window.

The port of ``src/repro/models/attention.py``, in its layout: heads are
(B, S, H, D) at every public function.  Two execution modes:

  * full sequence (prefill): causal (+ optional sliding window) attention,
    through one of three branches of :func:`full_attention` — a pad mask
    (ragged serving) takes the dense masked :func:`sdpa`; ``cfg.use_flash``
    takes the hand-written kernel ``repro_torch.kernels.flash_attention``;
    otherwise :func:`blockwise_attention` above 1024 tokens and :func:`sdpa`
    below, both plain PyTorch;
  * decode: one new token attending to the KV cache.

Masked logits take the finite value -1e30, never -inf: a fully masked row
(a pad query) then stays finite, and a NaN in a pad slot's v cannot leak
into real rows through 0 * NaN.  Logits are computed in fp32 from the
inputs' values (the reference's ``preferred_element_type=f32``).
Cross-attention (encoder-decoder models) is not ported yet (ROADMAP.md
Queue 1 item 10).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import apply_norm, apply_rope, dense, dense_init, norm_init

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.param_dtype
    dh = cfg.d_head
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, dt, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dt, bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dt, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(dh, dt, device=gen.device)
        p["k_norm"] = norm_init(dh, dt, device=gen.device)
    return p


def _split_heads(x, n_heads: int, d_head: int):
    return x.reshape(x.shape[:-1] + (n_heads, d_head))


def _merge_heads(x):
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def _repeat_kv(k, q_per_kv: int):
    """(B, S, Hkv, D) -> (B, S, Hq, D) by repeating each kv head."""
    if q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, q_per_kv, dim=2)


def _einsum32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of the operands' values in fp32 (exact products of bf16
    inputs, fp32 accumulation), fp32 out."""
    return torch.einsum(eq, a.float(), b.float())


def qkv_project(p, cfg: ModelConfig, x, positions=None, *, rope: bool = True):
    """Project and prepare q, k, v (with qk-norm + RoPE where configured)."""
    q = _split_heads(dense(p["wq"], x), cfg.n_heads, cfg.d_head)
    k = _split_heads(dense(p["wk"], x), cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(dense(p["wv"], x), cfg.n_kv_heads, cfg.d_head)
    if "q_norm" in p:
        q = apply_norm(p["q_norm"], q, cfg.norm_eps)
        k = apply_norm(p["k_norm"], k, cfg.norm_eps)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa(q, k, v, mask=None):
    """Reference scaled-dot-product attention.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D); mask broadcastable (B,H,Sq,Sk)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = _einsum32("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = _einsum32("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(v.dtype)


def blockwise_attention(q, k, v, *, causal=True, window=None, q_block=512, kv_block=512):
    """Flash-style online-softmax attention in plain PyTorch (memory
    O(block^2)), the reference's production full-sequence path without the
    kernel.  It visits every key block, as the reference does.

    q: (B, S, H, D); k, v: (B, S, H, D) (kv already head-repeated).
    """
    b, s, h, d = q.shape
    sk = k.shape[1]
    q_block = min(q_block, s)
    kv_block = min(kv_block, sk)
    if s % q_block or sk % kv_block:
        raise ValueError(f"blockwise_attention: lengths ({s}, {sk}) must be multiples of "
                         f"the blocks ({q_block}, {kv_block})")
    scale = 1.0 / np.sqrt(d)
    out = torch.empty((b, s, h, d), dtype=v.dtype, device=v.device)
    for qi in range(s // q_block):
        q_tile = q[:, qi * q_block:(qi + 1) * q_block].transpose(1, 2)  # (b, h, qb, d)
        q_pos = qi * q_block + torch.arange(q_block, device=q.device)
        acc = torch.zeros((b, h, q_block, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=q.device)
        for ki in range(sk // kv_block):
            k_tile = k[:, ki * kv_block:(ki + 1) * kv_block].transpose(1, 2)
            v_tile = v[:, ki * kv_block:(ki + 1) * kv_block].transpose(1, 2)
            logits = _einsum32("bhqd,bhkd->bhqk", q_tile, k_tile) * scale
            k_pos = ki * kv_block + torch.arange(kv_block, device=q.device)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool, device=q.device)
            if causal:
                mask = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            logits = logits.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _einsum32("bhqk,bhkd->bhqd", p.to(v.dtype), v_tile)
            m = m_new
        tile = acc / l.clamp_min(1e-30)[..., None]
        out[:, qi * q_block:(qi + 1) * q_block] = tile.transpose(1, 2).to(v.dtype)
    return out


def causal_mask(sq: int, sk: int, window: Optional[int] = None, device=None):
    """(1, 1, sq, sk) causal (+sliding window) mask; sk >= sq, aligned right."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m = m & (ki > qi - window)
    return m[None, None]


def full_attention(p, cfg: ModelConfig, x, positions, *, window=None, return_kv=False, pad_mask=None):
    """Prefill self-attention over a full sequence.

    ``pad_mask`` (B, S) bool — True at real tokens — excludes left-pad slots
    from the key set (ragged-batch prefill).  The padded slots' own outputs
    are garbage but nothing downstream reads them: decode masks them out of
    the KV cache via the same offsets, and prefill logits come from the last
    slot, which left-padding keeps real for every row.

    With ``cfg.use_flash`` and no pad mask, attention goes to the kernel,
    which on the card launches or raises; it never falls back to another
    branch.
    """
    q, k, v = qkv_project(p, cfg, x, positions)
    s = x.shape[1]
    if pad_mask is not None:
        # masked path: the kernel carries no key-validity mask
        kr = _repeat_kv(k, cfg.q_per_kv)
        vr = _repeat_kv(v, cfg.q_per_kv)
        mask = causal_mask(s, s, window, device=x.device) & pad_mask[:, None, None, :]
        out = sdpa(q, kr, vr, mask)
    elif cfg.use_flash:
        out = flash_attention(q, k, v, causal=True, window=window)
    else:
        kr = _repeat_kv(k, cfg.q_per_kv)
        vr = _repeat_kv(v, cfg.q_per_kv)
        if s > 1024:  # O(block^2) memory
            out = blockwise_attention(q, kr, vr, causal=True, window=window)
        else:
            out = sdpa(q, kr, vr, causal_mask(s, s, window, device=x.device))
    out = dense(p["wo"], _merge_heads(out))
    if return_kv:
        return out, k, v
    return out


def project_decode_kv(p, cfg: ModelConfig, x, position):
    """Project this token's k, v (with rope/qk-norm) for cache insertion."""
    _, k_new, v_new = qkv_project(p, cfg, x, positions=position[..., None])
    return k_new, v_new


def decode_attention(p, cfg: ModelConfig, x, cache_k, cache_v, position, *, window=None, slot=None):
    """Single-token decode: x (B, 1, d); cache_k/v (B, S, Hkv, D) — the cache
    ALREADY holds this token's k/v at buffer slot ``slot`` (the caller
    scatters first).  ``position`` (B,) is the token's LOGICAL position
    (drives RoPE); ``slot`` (B,) its cache-buffer slot, defaulting to
    ``position``.  Left-padded batches pass ``slot > position``: row i's
    real tokens occupy buffer slots [slot - position, slot], and the pad
    slots below are masked out.  Attends over that prefix, optionally
    limited to the last ``window`` positions.
    """
    q, _, _ = qkv_project(p, cfg, x, positions=position[..., None])
    return decode_attend(p, q, cache_k, cache_v, position, window=window, slot=slot)


def decode_attend(p, q, cache_k, cache_v, position, *, window=None, slot=None):
    """:func:`decode_attention` from this token's projected q (B, 1, Hq, D),
    for a caller that has already projected it with k and v (the
    reference projects twice and leaves the repeat to XLA to remove).

    Query head h reads kv head h // q_per_kv through a grouped product, the
    same arithmetic as the reference's repeated-kv form without the
    (B, S, Hq, D) copy of the cache.
    """
    if slot is None:
        slot = position
    b, _, hq, d = q.shape
    s, hkv = cache_k.shape[1], cache_k.shape[2]
    kv_pos = torch.arange(s, device=q.device)[None, :]  # (1, S)
    valid = (kv_pos <= slot[:, None]) & (kv_pos >= (slot - position)[:, None])
    if window is not None:
        valid = valid & (kv_pos > slot[:, None] - window)
    qg = q.reshape(b, 1, hkv, hq // hkv, d)
    logits = _einsum32("bqhgd,bkhd->bhgqk", qg, cache_k) * (1.0 / np.sqrt(d))
    logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = _einsum32("bhgqk,bkhd->bqhgd", probs.to(cache_v.dtype), cache_v).to(cache_v.dtype)
    return dense(p["wo"], out.reshape(b, 1, hq * d))
