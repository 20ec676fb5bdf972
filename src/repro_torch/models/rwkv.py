"""RWKV-6 "Finch" mixer: linear attention with data-dependent decay.

The port of ``src/repro/models/rwkv.py``.  Per head, with a (D, D) state::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + u k_t^T v_t)        (bonus u on the current token)

The full-sequence mixer evaluates the recurrence chunk by chunk: inside a
chunk, matmul-form attention over the chunk's tokens; across chunks, a
Python loop carries the state.  The decay between two tokens of a chunk
is one exponent computed PAIRWISE, masked to ``-inf`` above the causal
diagonal BEFORE ``exp``, so it stays <= 0 where it is kept; masking after
``exp`` would give ``inf * 0 = NaN`` in the forward or the gradient.
Nothing is written in place, so the mixer runs under ``torch.func.vmap``
with autograd (the federated cohort); the reference's ``jax.checkpoint``
of a chunk only saves memory and has no counterpart.

Decode is O(1): one rank-1 state update per token.  The token shift mixes
each token with its predecessor through learned per-channel weights; the
decay ``w_t`` is data-dependent through a rank-64 path (``w_a``, ``w_b``).
The state, the decay and the shift's fp32 mixes stay fp32 whatever the
model's dtype; the norm and the projections run in the model's dtype,
with the casts where the reference has them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.axes import is_dtensor, on_batch_shards
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import _normal, apply_norm, dense, dense_init, draw_from, norm_init

# the rank of the data-dependent decay's path, whatever d_model is
DECAY_RANK = 64


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv.head_size


def rwkv_init(gen: torch.Generator, cfg: ModelConfig):
    """Projections, token-shift mixes and the output norm in the model's
    dtype; ``w_base`` and ``bonus`` in fp32."""
    dt, d, dev = cfg.param_dtype, cfg.d_model, gen.device
    return {
        # token-shift mixing coefficients per channel for r/k/v/w/g
        "mix": torch.rand((5, d), generator=draw_from(gen), device=dev, dtype=torch.float32).to(dt),
        "wr": dense_init(gen, d, d, dt),
        "wk": dense_init(gen, d, d, dt),
        "wv": dense_init(gen, d, d, dt),
        "wg": dense_init(gen, d, d, dt),
        # data-dependent decay: w_t = exp(-exp(base + tanh(x A) B))
        "w_base": torch.full((d,), -0.5, dtype=torch.float32, device=dev),
        "w_a": dense_init(gen, d, DECAY_RANK, dt),
        "w_b": dense_init(gen, DECAY_RANK, d, dt),
        "bonus": _normal(gen, (_n_heads(cfg), cfg.rwkv.head_size), 0.05, torch.float32),
        "ln_x": norm_init(d, dt, "layernorm", device=dev),
        "wo": dense_init(gen, d, d, dt),
    }


def _token_shift(x: torch.Tensor, x_prev_last: torch.Tensor) -> torch.Tensor:
    """Shift right by one: out[t] = x[t-1]; the first slot from the carry."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _projections(p, cfg: ModelConfig, x: torch.Tensor, shifted: torch.Tensor):
    """r, k, v in x's dtype; the decay w in (0, 1) and the gate g in fp32."""
    mix = p["mix"].float()
    xf, sf = x.float(), shifted.float()

    def mixed(i):
        return (xf * mix[i] + sf * (1.0 - mix[i])).to(x.dtype)

    r = dense(p["wr"], mixed(0))
    k = dense(p["wk"], mixed(1))
    v = dense(p["wv"], mixed(2))
    xw = mixed(3)
    g = F.silu(dense(p["wg"], mixed(4)).float())
    lora = dense(p["w_b"], torch.tanh(dense(p["w_a"], xw).float()).to(x.dtype)).float()
    w = torch.exp(-torch.exp(p["w_base"] + lora))  # (B, S, d)
    return r, k, v, w, g


def _heads(x: torch.Tensor, nh: int, hs: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], nh, hs)


def _chunk_step(state, rch, kch, vch, wch, u, tri):
    """One chunk: (b, nh, C, hs) inputs and the carried (b, nh, hs, hs)
    state -> (the state at the chunk's end, y (b, nh, C, hs))."""
    logw = torch.log(torch.clamp_min(wch, 1e-12))
    cum = torch.cumsum(logw, dim=2)  # sum_{i<=t} log w_i
    cumx = cum - logw  # sum_{i<=t-1} log w_i
    total = cum[:, :, -1:, :]
    # intra-chunk: y_t += sum_{j<t} r_t . (prod_{i=j+1}^{t-1} w_i) k_j v_j,
    # D[t, j] = exp(cumx[t] - cum[j]) per key channel, the exponent masked
    # to -inf above the diagonal before exp
    diff = cumx[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nh, C, C, hs)
    diff = torch.where(tri[:, :, None], diff, -math.inf)
    att = torch.einsum("bhtd,bhsd,bhtsd->bhts", rch, kch, torch.exp(diff))
    diag = torch.einsum("bhtd,bhtd->bht", rch * u[None, :, None, :], kch)
    y = torch.einsum("bhts,bhsd->bhtd", att, vch)
    y = y + diag[..., None] * vch
    # the carried state, decayed from the chunk's start to t-1
    y = y + torch.einsum("bhtd,bhde->bhte", rch * torch.exp(cumx), state)
    # the state at the chunk's end: diag(exp total) S + sum_j exp(total - cum[j]) k_j v_j
    ktil = kch * torch.exp(total - cum)
    s_new = torch.exp(total)[:, :, 0, :, None] * state
    s_new = s_new + torch.einsum("bhtd,bhte->bhde", ktil, vch)
    return s_new, y


def rwkv_mixer(p, cfg: ModelConfig, x: torch.Tensor, chunk: int = 64, *, return_state: bool = False):
    """Full-sequence mixer via the chunked recurrence. x: (B, S, d).

    ``chunk = min(chunk, S)``; a sequence that is not a multiple is
    zero-padded at its end, except with ``return_state``, where the chunk
    drops to ``gcd(chunk, S)`` (the reference's rule: a 2047-token prompt
    runs 2047 one-token chunks) so that the returned state ``{"s",
    "x_prev"}`` is that of the last real token."""
    if is_dtensor(x):  # the sharded step: data-parallel, the weights gathered
        out = on_batch_shards(lambda p, x: _as_tuple(rwkv_mixer(p, cfg, x, chunk, return_state=return_state)), p, x)
        return (out[0], {"s": out[1], "x_prev": out[2]}) if return_state else out[0]
    b, s, d = x.shape
    chunk = min(chunk, s)
    if return_state and s % chunk:
        chunk = math.gcd(chunk, s) or s
    nh, hs = _n_heads(cfg), cfg.rwkv.head_size
    shifted = _token_shift(x, torch.zeros((b, d), dtype=x.dtype, device=x.device))
    r, k, v, w, g = _projections(p, cfg, x, shifted)
    pad = (-s) % chunk
    r, k, v, w = (F.pad(_heads(t.float(), nh, hs), (0, 0, 0, 0, 0, pad)) for t in (r, k, v, w))
    nc = (s + pad) // chunk

    def to_chunks(t):  # (b, S, nh, hs) -> (nc, b, nh, C, hs)
        return t.reshape(b, nc, chunk, nh, hs).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = (to_chunks(t) for t in (r, k, v, w))
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril(-1)
    state = torch.zeros((b, nh, hs, hs), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        state, y = _chunk_step(state, rc[i], kc[i], vc[i], wc[i], p["bonus"], tri)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, nc * chunk, nh, hs)[:, :s]
    y = y.reshape(b, s, d)
    y = apply_norm(p["ln_x"], y.to(x.dtype), cfg.norm_eps)
    y = (y.float() * g).to(x.dtype)
    out = dense(p["wo"], y)
    if return_state:
        return out, {"s": state, "x_prev": x[:, -1].float()}
    return out


def _as_tuple(out):
    """A mixer's output as a flat tuple: (y,) or (y, s, x_prev)."""
    return (out[0], out[1]["s"], out[1]["x_prev"]) if isinstance(out, tuple) else (out,)


def rwkv_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *, device="cuda"):
    """Zeroed decode state in ``dtype`` (fp32 by default): ``s`` (B, nh,
    hs, hs), ``x_prev`` (B, d_model), on ``device`` (default ``"cuda"``,
    which raises without CUDA: ``repro_torch.device``)."""
    device = resolve_device(device, meta=True)
    nh, hs = _n_heads(cfg), cfg.rwkv.head_size
    return {
        "s": torch.zeros((batch, nh, hs, hs), dtype=dtype, device=device),
        "x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }


def rwkv_decode_step(p, cfg: ModelConfig, x: torch.Tensor, state) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d).  Returns (out (B, 1, d), the new state); the given
    state is not written."""
    b, _, d = x.shape
    nh, hs = _n_heads(cfg), cfg.rwkv.head_size
    shifted = state["x_prev"][:, None, :].to(x.dtype)
    r, k, v, w, g = _projections(p, cfg, x, shifted)
    r, k, v, w = (t[:, 0].float().reshape(b, nh, hs) for t in (r, k, v, w))
    s = state["s"].float()
    kv = k[..., :, None] * v[..., None, :]  # (b, nh, hs, hs)
    y = torch.einsum("bhd,bhde->bhe", r, s + p["bonus"][None, :, :, None] * kv)
    s_new = w[..., :, None] * s + kv
    y = apply_norm(p["ln_x"], y.reshape(b, 1, d).to(x.dtype), cfg.norm_eps)
    y = (y.float() * g).to(x.dtype)
    out = dense(p["wo"], y)
    return out, {"s": s_new.to(state["s"].dtype), "x_prev": x[:, 0].to(state["x_prev"].dtype)}
