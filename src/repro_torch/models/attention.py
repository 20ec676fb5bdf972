"""Grouped-query attention with RoPE, qk-norm, QKV bias, sliding window.

The port of ``src/repro/models/attention.py``, in its layout: heads are
(B, S, H, D) at every public function.  Three execution modes:

  * full sequence (prefill): causal (+ optional sliding window) attention,
    through one of three branches of :func:`full_attention` — a pad mask
    (ragged serving) takes the dense masked :func:`sdpa`; ``cfg.use_flash``
    takes the hand-written kernel ``repro_torch.kernels.flash_attention``;
    otherwise :func:`blockwise_attention` above 1024 tokens and :func:`sdpa`
    below, both plain PyTorch;
  * decode: one new token attending to the KV cache;
  * cross: encoder-decoder cross-attention (whisper), plain :func:`sdpa`
    over the encoder's K and V, unmasked, as the reference computes it.

Masked logits take the finite value -1e30, never -inf: a fully masked row
(a pad query) then stays finite, and a NaN in a pad slot's v cannot leak
into real rows through 0 * NaN.  Logits are computed in fp32 from the
inputs' values (the reference's ``preferred_element_type=f32``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.axes import is_dtensor, kind_spec, on_shards, redistribute_to, shard_offset, spec_of
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import apply_norm, apply_rope, dense, dense_init, norm_init

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, cross: bool = False):
    """q, k, v and output projections; qk-norm scales where configured,
    except for cross-attention (``cross``), as in the reference."""
    dt = cfg.param_dtype
    dh = cfg.d_head
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, dt, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dt, bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dt, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model, dt),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = norm_init(dh, dt, device=gen.device)
        p["k_norm"] = norm_init(dh, dt, device=gen.device)
    return p


def _heads_spec(shape, n_kv_heads: int):
    """Under sharding hints, the reference's ``"heads"`` layout of a
    (B, S, H, D) activation, its heads over the model axis only where the
    KV heads divide it (then every rank's query heads read its own KV
    heads); None with no hints."""
    spec = kind_spec(tuple(shape[:2]) + (n_kv_heads,) + tuple(shape[3:]), "heads")
    return spec


def _split_heads(x, n_heads: int, d_head: int, n_kv_heads: int = 0):
    shape = tuple(x.shape[:-1]) + (n_heads, d_head)
    if is_dtensor(x):  # lay the flat heads out as the split will have them
        spec = _heads_spec(shape, n_kv_heads or n_heads)
        if spec is not None:
            x = redistribute_to(x, spec[:-1])
    return x.reshape(shape)


def _on_heads(fn, q, k, v):
    """``fn(q, k, v)`` (B, S, H, D) each, on the local heads and batch
    rows of DTensor inputs (:func:`on_shards`; plain tensors go straight
    to ``fn``)."""
    if not is_dtensor(q):
        return fn(q, k, v)
    spec_kv = _heads_spec(k.shape, k.shape[2])
    spec_q = _heads_spec(q.shape, k.shape[2])
    return on_shards(fn, (q, k, v), (spec_q, spec_kv, spec_kv), (spec_q,))


def _merge_heads(x):
    y = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
    if is_dtensor(y):  # the cotangent in the heads' layout, so it splits back
        y = redistribute_to(y, spec_of(y))
    return y


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
    q = _split_heads(dense(p["wq"], x), cfg.n_heads, cfg.d_head, cfg.n_kv_heads)
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
        def core(q, k, v):
            kr = _repeat_kv(k, cfg.q_per_kv)
            vr = _repeat_kv(v, cfg.q_per_kv)
            if s > 1024:  # O(block^2) memory
                return blockwise_attention(q, kr, vr, causal=True, window=window)
            return sdpa(q, kr, vr, causal_mask(s, s, window, device=q.device))

        out = _on_heads(core, q, k, v)
    out = dense(p["wo"], _merge_heads(out))
    if return_kv:
        return out, k, v
    return out


def cross_attention(p, cfg: ModelConfig, x, enc_kv):
    """Decoder->encoder attention; enc_kv = (k, v) precomputed from the
    encoder output (:func:`encoder_kv`).  No RoPE, no mask."""
    q = _split_heads(dense(p["wq"], x), cfg.n_heads, cfg.d_head, cfg.n_kv_heads)
    k, v = enc_kv
    out = _on_heads(lambda q, k, v: sdpa(q, _repeat_kv(k, cfg.q_per_kv), _repeat_kv(v, cfg.q_per_kv), mask=None),
                    q, k, v)
    return dense(p["wo"], _merge_heads(out))


def encoder_kv(p, cfg: ModelConfig, enc_out):
    """Cross-attention K, V of one encoder output (B, F, d), computed once
    per sequence: (B, F, Hkv, D) each."""
    k = _split_heads(dense(p["wk"], enc_out), cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(dense(p["wv"], enc_out), cfg.n_kv_heads, cfg.d_head)
    return k, v


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


def decode_write_attend_sharded(p, q, k_new, v_new, cache_k, cache_v, position, *, window=None, slot=None):
    """:func:`decode_attend` over a DTensor cache (B, S, Hkv, D) laid out
    as ``cache_specs`` lays it (the batch over the data axes, the sequence
    over the model axis or more: context-parallel decode), after writing
    this token's k and v into it.  Flash-decoding: each rank writes the
    token where its slot lies in the rank's slice of the sequence and
    attends over that slice (its max logit, softmax sum and unnormalized
    output), and the slices are combined by their maxima."""
    from repro_torch.distributed.sharding import P

    if slot is None:
        slot = position
    b, _, hq, d = q.shape
    hkv = cache_k.shape[2]
    cspec = spec_of(cache_k)
    rows, seq = cspec[0], cspec[1]
    lo = shard_offset(cache_k, 1)
    tok = P(rows, None, None, None)

    def local(q, k_new, v_new, ck, cv, position, slot):
        bl, sl = ck.shape[0], ck.shape[1]
        at = slot - lo
        inside = ((at >= 0) & (at < sl))[:, None, None]
        idx = at.clamp(0, sl - 1)
        bidx = torch.arange(bl, device=q.device)
        ck[bidx, idx] = torch.where(inside, k_new[:, 0].to(ck.dtype), ck[bidx, idx])
        cv[bidx, idx] = torch.where(inside, v_new[:, 0].to(cv.dtype), cv[bidx, idx])
        kv_pos = lo + torch.arange(sl, device=q.device)[None, :]
        valid = (kv_pos <= slot[:, None]) & (kv_pos >= (slot - position)[:, None])
        if window is not None:
            valid = valid & (kv_pos > slot[:, None] - window)
        qg = q.reshape(bl, 1, hkv, hq // hkv, d)
        logits = _einsum32("bqhgd,bkhd->bhgqk", qg, ck) * (1.0 / np.sqrt(d))
        logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        o = _einsum32("bhgqk,bkhd->bqhgd", e.to(cv.dtype), cv)
        return m[None], e.sum(dim=-1, keepdim=True)[None], o[None]

    stats = P(seq, rows, None, None, None, None)
    m, l, o = on_shards(local, (q, k_new, v_new, cache_k, cache_v, position, slot),
                        (tok, tok, tok, cspec, cspec, P(rows), P(rows)), (stats, stats, stats))
    top = m.amax(dim=0)
    w = torch.exp(m - top)  # (n, B, H, g, 1, 1)
    total = (l * w).sum(dim=0)  # (B, H, g, 1, 1)
    out = (o * w[..., 0].permute(0, 1, 4, 2, 3)[..., None]).sum(dim=0)  # (B, 1, H, g, D)
    out = out / total[..., 0].permute(0, 3, 1, 2)[..., None]
    return dense(p["wo"], out.to(cache_v.dtype).reshape(b, 1, hq * d))
