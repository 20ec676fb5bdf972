"""Causal (+ sliding window) grouped-query attention, online softmax.

Replaces the Pallas kernel ``flash_attention`` of the reference
(``src/repro/kernels/flash_attention.py``: ``_flash_kernel``).  The model
calls it from ``models.attention.full_attention`` when ``cfg.use_flash`` is
set and no pad mask is given: the serving engine's uniform-length prefill.

What it computes: for q (B, S, Hq, D) and k, v (B, S, Hkv, D), query head h
attends over kv head ``h // (Hq // Hkv)`` at key positions ``k <= q`` (and
``k > q - window`` with a window), positions counted from 0 on both axes,
in fp32, masked logits at the finite -1e30; the result is in q's dtype.
Because the TPU kernel counts positions from 0 on both axes while its
reference right-aligns the queries, the contract is ``sq == sk``, and both
versions here reject other shapes.

What bounds it on an H100: operations (``csrc/flash_attention_sm90.cu``
has the numbers at the qwen3-14b serve prefill).  Two CUDA kernels:

- bf16 (the serve path): ``csrc/flash_attention_sm90.cu``, ``wgmma`` for
  both products, TMA loads into a ring of shared-memory stages, fp32
  softmax state in registers; one CTA per (batch, query head, 128 query
  rows).  It rounds p to bf16 for the p . v product, as the reference's
  non-flash path does; held to the bf16 tolerance, 2e-2.  Head dims
  ``WGMMA_HEAD_DIMS``; q, k and v need 16-byte aligned base addresses and
  strides (TMA's rule), else the wrapper raises ``ValueError``.
- fp32: ``csrc/flash_attention.cu``, a SIMT kernel in full fp32 (``wgmma``
  takes fp32 only as TF32, which would miss the 2e-5 fp32 tolerance): one
  block of 256 threads per (batch, query head, 128 query rows), a loop over
  64-row key tiles (``SIMT_TILE``) copied by ``cp.async`` into two shared-
  memory buffers, scores and output register-blocked per thread, logits in
  the base-2 domain, one reciprocal per row.  Head dims
  ``KERNEL_HEAD_DIMS``.

Both skip key tiles outside the causal band or the window, read q, k and
v through their strides (the last axis must be contiguous) and write a
contiguous output.  Nothing falls back: an input neither kernel takes
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import check_launch, ptr, stream_of

NEG_INF = -1e30
# head dims the fp32 SIMT kernel is instantiated for (csrc/flash_attention.cu):
# every dense config's, full (128; 96 for phi3-mini) and smoke (16, 32)
KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128)
# the fp32 SIMT kernel's tile: query rows per block, key rows per tile
# (kBQ, kBK in csrc/flash_attention.cu; ``simt_kernel_tile`` reads them back)
SIMT_TILE = (128, 64)
# head dims of the bf16 wgmma kernel (csrc/flash_attention_sm90.cu): every
# full config's; no bf16 config has d 16 or 32 (the smoke configs are fp32)
WGMMA_HEAD_DIMS = (64, 96, 128)
_MAX_Q_TILES = 65535  # grid.y
_Q_TILE = {"simt": SIMT_TILE[0], "wgmma": 128}
VARIANTS = {torch.float32: "simt", torch.bfloat16: "wgmma"}


def _check(q, k, v, window, name: str):
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a torch.Tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {what} must be (B, S, H, D), got shape {tuple(t.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v lie on {q.device}, {k.device}, {v.device}")
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: k and v must be (B, S, Hkv, D) matching q {tuple(q.shape)}; "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] != s:
        raise ValueError(f"{name}: query and key lengths differ ({s} vs {k.shape[1]}); "
                         "positions count from 0 on both axes, so sq must equal sk")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{name}: {hq} query heads are not a multiple of {k.shape[2]} kv heads")
    if window is not None and int(window) < 1:
        raise ValueError(f"{name}: window must be a positive int or None, got {window!r}")


def flash_attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: full softmax over the masked logits in fp32,
    one chunk of query rows at a time (so the (B, H, rows, S) logits stay
    near 1 GB), cast to q's dtype."""
    _check(q, k, v, window, "flash_attention_ref")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / np.sqrt(d)
    qf = q.float().reshape(b, s, hkv, g, d)
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kpos = torch.arange(s, device=q.device)
    chunk = max(1, min(s, (1 << 28) // max(1, b * hq * s)))
    for i0 in range(0, s, chunk):
        i1 = min(s, i0 + chunk)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, i0:i1], kf) * scale
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        mask = torch.ones((i1 - i0, s), dtype=torch.bool, device=q.device)
        if causal:
            mask = kpos[None, :] <= qpos
        if window is not None:
            mask = mask & (kpos[None, :] > qpos - window)
        probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
        out[:, i0:i1] = o.reshape(b, i1 - i0, hq, d).to(q.dtype)
    return out


def simt_kernel_tile() -> tuple:
    """(query rows, key rows) of the built fp32 kernel's tile, read from the
    library (builds it if needed): must equal ``SIMT_TILE``."""
    lib = load_library()
    return (lib.repro_flash_attention_f32_tile(0), lib.repro_flash_attention_f32_tile(1))


def _check_wgmma(q, k, v, name: str) -> None:
    """Raise ``ValueError`` for a bf16 input the wgmma kernel cannot take:
    its head dim, or a base address or (batch, seq, head) stride that is
    not a multiple of 16 bytes (TMA reads tiles only on that grid)."""
    d = q.shape[3]
    if d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"{name}: the bf16 wgmma kernel takes head dims {WGMMA_HEAD_DIMS}, got {d}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} starts at an address that is not 16-byte aligned "
                             "(TMA needs 16-byte aligned tensors)")
        if any((st * t.element_size()) % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name}: {what} has strides {tuple(t.stride())}: the batch, sequence and "
                             "head strides must be multiples of 16 bytes (TMA's rule)")


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    """Launch the dtype's CUDA kernel on checked inputs.  Counts nothing."""
    b, s, hq, d = q.shape
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    dims = (ctypes.c_int64 * 5)(b, s, hq, k.shape[2], d)
    strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = load_library()
    entry = lib.repro_flash_attention_f32 if q.dtype == torch.float32 else lib.repro_flash_attention_wgmma_bf16
    with torch.cuda.device(q.device):
        code = entry(
            ptr(q), ptr(k), ptr(v), ptr(out), dims, strides, float(1.0 / np.sqrt(d)),
            int(bool(causal)), int(window or 0), stream_of(q.device),
        )
    check_launch(code, "flash_attention")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) with Hq % Hkv == 0, float32 or
    bfloat16.  Returns (B, S, Hq, D) in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch a kernel (and
    count one launch in ``flash_attention.launches`` and one in
    ``flash_attention.launches_by_variant[variant]``) or raise: bf16 the
    ``"wgmma"`` kernel, fp32 the ``"simt"`` one.  A shape the dtype's kernel
    does not take raises ``ValueError`` (a head dim outside
    ``WGMMA_HEAD_DIMS`` / ``KERNEL_HEAD_DIMS``, a last axis that is not
    contiguous, bf16 strides or addresses off TMA's 16-byte grid).
    """
    name = "flash_attention"
    _check(q, k, v, window, name)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA device, got {q.device}")
    variant = VARIANTS[q.dtype]
    b, s, hq, d = q.shape
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the last axis of q, k and v must be contiguous")
    if variant == "wgmma":
        _check_wgmma(q, k, v, name)
    elif d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the fp32 CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    if -(-s // _Q_TILE[variant]) > _MAX_Q_TILES:
        raise ValueError(f"{name}: sequence length {s} exceeds the kernel's {_MAX_Q_TILES * _Q_TILE[variant]}")
    if b * hq >= 2**31:
        raise ValueError(f"{name}: batch x heads = {b * hq} exceeds the kernel's grid")
    if b * s * hq * d == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    out = _launch(q, k, v, causal, window)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_variant = {"wgmma": 0, "simt": 0}
