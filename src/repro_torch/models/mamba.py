"""Selective state-space mixer (Mamba / S6) for the Jamba hybrid stacks.

The port of ``src/repro/models/mamba.py``.  State update (diagonal A)::

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

The full-sequence mixer evaluates the recurrence chunk by chunk: a Python
loop over chunks carries the (B, d_inner, d_state) state, and inside a
chunk an inclusive scan under ``combine((dl, hl), (dr, hr)) = (dl * dr,
hr + dr * hl)`` runs in fp32.  The reference's in-chunk scan is
``jax.lax.associative_scan``; here it is a log-depth doubling
(:func:`_scan_chunk`), which combines the same terms in another order
(held to the reference at 1e-5 in fp32).  Every step builds new tensors
and writes none in place, so the mixer runs under ``torch.func.vmap`` with
autograd (the federated cohort).  The reference's ``jax.checkpoint`` of a
chunk only saves memory and has no counterpart.

Decode is the O(1) single-step recurrence on the (B, d_inner, d_state)
carry plus the last ``d_conv - 1`` pre-convolution activations.  Both
states are fp32 whatever the model's dtype; the casts to fp32 and back sit
where the reference has them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.axes import is_dtensor, on_batch_shards
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import _normal, dense, dense_init


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def mamba_init(gen: torch.Generator, cfg: ModelConfig):
    """In/out projections in the model's dtype; ``a_log`` (S4D-real, log of
    1..d_state per channel) and ``d_skip`` in fp32."""
    s, dt, dev = cfg.ssm, cfg.param_dtype, gen.device
    d_inner = s.expand * cfg.d_model
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32, device=dev).repeat(d_inner, 1)
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * d_inner, dt),
        "conv_w": _normal(gen, (s.d_conv, d_inner), 0.1, dt),
        "conv_b": torch.zeros((d_inner,), dtype=dt, device=dev),
        "x_proj": dense_init(gen, d_inner, _dt_rank(cfg) + 2 * s.d_state, dt),
        "dt_proj": dense_init(gen, _dt_rank(cfg), d_inner, dt, bias=True),
        "a_log": torch.log(a),  # (d_inner, d_state) fp32
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dt),
    }


def _causal_conv(p, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over the sequence: x (B, S, d_inner)."""
    k = p["conv_w"].shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    # depthwise: sum_j w[j, c] * x[t - (k-1) + j, c]
    out = sum(pad[:, j : j + x.shape[1], :] * p["conv_w"][j].to(x.dtype) for j in range(k))
    return out + p["conv_b"].to(x.dtype)


def _scan_chunk(decay: torch.Tensor, drive: torch.Tensor):
    """Inclusive scan of (decay, drive) along axis 1 under the combine
    ``(dl, hl), (dr, hr) -> (dl * dr, hr + dr * hl)``: returns the running
    decay product and the state each step reaches from a zero start.
    Log-depth doubling (Hillis-Steele): at offset s each step folds in the
    partial result s steps back (ones and zeros before the start)."""
    c, s = decay.shape[1], 1
    while s < c:
        d_prev = F.pad(decay[:, :-s], (0, 0, 0, 0, s, 0), value=1.0)
        h_prev = F.pad(drive[:, :-s], (0, 0, 0, 0, s, 0))
        drive = drive + decay * h_prev
        decay = decay * d_prev
        s *= 2
    return decay, drive


def mamba_mixer(p, cfg: ModelConfig, u: torch.Tensor, *, return_state: bool = False, chunk: int = 128):
    """Full-sequence mixer. u: (B, S, d_model) -> (B, S, d_model).

    The recurrence runs chunk by chunk (``chunk = min(chunk, S)``; a
    sequence that is not a multiple is zero-padded at its end).  With
    ``return_state`` it also returns the final recurrent state ``{"h",
    "conv"}`` for the prefill -> decode handoff, which the padding would
    corrupt: a sequence that needs it raises ``ValueError``, where the
    reference fails its ``assert``."""
    if is_dtensor(u):  # the sharded step: data-parallel, the weights gathered
        out = on_batch_shards(lambda p, u: _as_tuple(mamba_mixer(p, cfg, u, return_state=return_state, chunk=chunk)),
                              p, u)
        return (out[0], {"h": out[1], "conv": out[2]}) if return_state else out[0]
    bsz, seq, _ = u.shape
    chunk = min(chunk, seq)
    pad = (-seq) % chunk
    if return_state and pad:
        raise ValueError(
            f"return_state requires seq % chunk == 0 (a {seq}-token sequence in chunks of {chunk}); "
            "the handed-off state would include the padding"
        )
    s = cfg.ssm
    x_raw, z = dense(p["in_proj"], u).chunk(2, dim=-1)
    x = F.silu(_causal_conv(p, x_raw).float()).to(u.dtype)
    # dt/B/C are computed on the convolved activation (mamba ordering)
    dt_in, b, c = torch.split(dense(p["x_proj"], x), [_dt_rank(cfg), s.d_state, s.d_state], dim=-1)
    dt_full = F.softplus(dense(p["dt_proj"], dt_in).float())  # (B, S, di)
    a = -torch.exp(p["a_log"])  # (di, n)

    x_c, dt_c, b_c, c_c = (F.pad(t, (0, 0, 0, pad)) if pad else t for t in (x, dt_full, b, c))
    h = torch.zeros((bsz, x.shape[-1], s.d_state), dtype=torch.float32, device=u.device)
    ys = []
    for i in range(0, seq + pad, chunk):
        xc, dtc, bc, cc = (t[:, i : i + chunk] for t in (x_c, dt_c, b_c, c_c))
        decay = torch.exp(dtc[..., None] * a)  # (B, C, di, n)
        drive = dtc[..., None] * bc[:, :, None, :].float() * xc.float()[..., None]
        dcum, hloc = _scan_chunk(decay, drive)
        hs = hloc + dcum * h[:, None]  # (B, C, di, n)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, cc.float()))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :seq]
    y = y + p["d_skip"] * x.float()
    y = y * F.silu(z.float())
    out = dense(p["out_proj"], y.to(u.dtype))
    if not return_state:
        return out
    k = p["conv_w"].shape[0]
    tail = x_raw[:, -(k - 1) :, :].float()
    tail = F.pad(tail, (0, 0, (k - 1) - tail.shape[1], 0))
    return out, {"h": h, "conv": tail}


def _as_tuple(out):
    """A mixer's output as a flat tuple: (y,) or (y, h, conv)."""
    return (out[0], out[1]["h"], out[1]["conv"]) if isinstance(out, tuple) else (out,)


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *, device="cuda"):
    """Zeroed decode state in ``dtype`` (fp32 by default): ``h`` (B,
    d_inner, d_state), ``conv`` (B, d_conv - 1, d_inner), on ``device``
    (default ``"cuda"``, which raises without CUDA: ``repro_torch.device``)."""
    device = resolve_device(device, meta=True)
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, d_inner, s.d_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, d_inner), dtype=dtype, device=device),
    }


def mamba_decode_step(p, cfg: ModelConfig, u: torch.Tensor, state) -> Tuple[torch.Tensor, dict]:
    """Single-token step. u: (B, 1, d_model); ``state`` carries ``h`` and the
    convolution's tail.  Returns (out (B, 1, d_model), the new state); the
    given state is not written."""
    x_raw, z = dense(p["in_proj"], u).chunk(2, dim=-1)  # (B, 1, di)
    # causal convolution over the stored tail and this token
    window = torch.cat([state["conv"].to(x_raw.dtype), x_raw], dim=1)  # (B, k, di)
    k = p["conv_w"].shape[0]
    x = sum(window[:, j, :] * p["conv_w"][j].to(x_raw.dtype) for j in range(k))
    x = F.silu((x + p["conv_b"].to(x.dtype)).float()).to(u.dtype)  # (B, di)
    s = cfg.ssm
    dt_in, b, c = torch.split(dense(p["x_proj"], x), [_dt_rank(cfg), s.d_state, s.d_state], dim=-1)
    dt_full = F.softplus(dense(p["dt_proj"], dt_in).float())  # (B, di)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt_full[..., None] * a)  # (B, di, n)
    drive = dt_full[..., None] * b[:, None, :].float() * x.float()[..., None]
    h = decay * state["h"] + drive
    y = torch.einsum("bdn,bn->bd", h, c.float())
    y = y + p["d_skip"] * x.float()
    y = y * F.silu(z[:, 0].float())
    out = dense(p["out_proj"], y.to(u.dtype))[:, None, :]
    return out, {"h": h, "conv": window[:, 1:, :].to(state["conv"].dtype)}
