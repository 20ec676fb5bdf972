"""Optimizers written out elementwise, as the reference writes them.

Each optimizer is an (init, update) pair over a tree (nested dict of
tensors, or one bare tensor such as the cohort's flat (C, D) matrix):

    state = init(params)
    new_params, new_state = update(params, grads, state, step)

``adam`` (and ``adamw``) also carry ``update_(params, grads, state,
step)``: the same arithmetic, operation for operation, written into the
parameters' and moments' own storage by ``kernels.adam_update_``, one call
a leaf (the functional form holds a second parameter tree and a second
pair of moments, which at phi3-mini-3.8b's widths does not fit one 80 GB
card beside the gradients).  On CUDA that is one fused launch a leaf,
reading p, g, m and v once and writing p, m and v once; on the CPU (and
meta and fake tensors) its plain version, a 16M-element slice of the leaf
at a time.  It is bit-identical to ``update``.

``torch.optim.Adam`` is not used: its operation order differs from the
reference's, and the engines are held to the reference's trajectory.
``step`` is a Python int counting from 0; ``schedule(step)`` returns the
learning-rate factor as a float32 scalar, as the reference's schedules
compute it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.adam import adam_update_
from repro_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (params, grads, state, step) -> (params, state)
    name: str
    update_: Optional[Callable] = None  # (params, grads, state, step) -> None, in place


def sgd(lr: float = 0.01, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(params, grads, state, step):
        del step
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads), state
        vel = tree_map(lambda v, g: momentum * v + g, state, grads)
        return tree_map(lambda p, v: p - lr * v.to(p.dtype), params, vel), vel

    return Optimizer(init, update, f"sgd(lr={lr},m={momentum})")


def adam(
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    schedule: Optional[Callable] = None,
    moment_dtype=None,
) -> Optimizer:
    """Adam; ``step`` counts from 0, so t = step + 1.

    weight_decay: added to the update as ``weight_decay * p`` (decoupled,
        AdamW's form); schedule: ``step -> float32`` factor on ``lr``;
    moment_dtype: store m and v in a reduced dtype (e.g. ``torch.bfloat16``,
        half the optimizer state); the update math stays fp32."""
    mdt = moment_dtype or torch.float32

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)  # noqa: E731
        return tree_map(zeros, params), tree_map(zeros, params)

    def scales(step):
        t = np.float32(step) + np.float32(1.0)
        # bias corrections and the scheduled rate in float32, as the reference computes them
        mh_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** t))
        vh_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t))
        lr_t = lr if schedule is None else float(np.float32(lr) * np.float32(schedule(step)))
        return mh_scale, vh_scale, lr_t

    def new_m(mm, g):
        return (b1 * mm.float() + (1 - b1) * g.float()).to(mdt)

    def new_v(vv, g):
        return (b2 * vv.float() + (1 - b2) * torch.square(g.float())).to(mdt)

    def new_p(p, mm, vv, mh_scale, vh_scale, lr_t):
        upd = (mm.float() * mh_scale) / (torch.sqrt(vv.float() * vh_scale) + eps)
        if weight_decay:
            upd = upd + weight_decay * p.float()
        return (p.float() - lr_t * upd).to(p.dtype)

    def update(params, grads, state, step):
        m, v = state
        m = tree_map(new_m, m, grads)
        v = tree_map(new_v, v, grads)
        sc = scales(step)
        return tree_map(lambda p, mm, vv: new_p(p, mm, vv, *sc), params, m, v), (m, v)

    @torch.no_grad()
    def update_(params, grads, state, step):
        mh_scale, vh_scale, lr_t = scales(step)
        m, v = state
        for p, g, mm, vv in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(m), tree_leaves(v),
                                strict=True):
            # a gradient may come strided (the leaves are contiguous); the kernel reads it flat
            adam_update_(p, g.contiguous(), mm, vv, b1=b1, b2=b2, eps=eps, lr_t=lr_t, mh_scale=mh_scale,
                         vh_scale=vh_scale, weight_decay=weight_decay)

    wd = f",wd={weight_decay}" if weight_decay else ""
    return Optimizer(init, update, f"adam(lr={lr}{wd})", update_)


def adamw(lr: float = 3e-4, weight_decay: float = 0.1, **kw) -> Optimizer:
    return adam(lr=lr, weight_decay=weight_decay, **kw)


def cosine_schedule(total_steps: int, warmup: int = 0, floor: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total_steps``; ``step -> float32`` factor."""
    f32 = np.float32

    def fn(step):
        s = f32(step)
        warm = min(s / f32(max(warmup, 1)), f32(1.0))
        prog = np.clip((s - f32(warmup)) / f32(max(total_steps - warmup, 1)), f32(0.0), f32(1.0))
        cos = f32(floor) + f32(1 - floor) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
        return f32(warm * cos)

    return fn


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares (a
    0-d fp32 tensor on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm), each leaf kept in
    its dtype; the scale and norm are device scalars (no host read)."""
    norm = _global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """:func:`clip_by_global_norm` written into the gradients' own storage
    (the train step's, which owns them); returns the norm."""
    norm = _global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return norm
