"""Optimizers written out elementwise, as the reference writes them.

Each optimizer is an (init, update) pair over a tree (nested dict of
tensors, or one bare tensor such as the cohort's flat (C, D) matrix):

    state = init(params)
    new_params, new_state = update(params, grads, state, step)

``torch.optim.Adam`` is not used: its operation order differs from the
reference's, and the engines are held to the reference's trajectory.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (params, grads, state, step) -> (params, state)
    name: str


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


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam with fp32 moments; ``step`` counts from 0, so t = step + 1."""

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return tree_map(zeros, params), tree_map(zeros, params)

    def update(params, grads, state, step):
        m, v = state
        t = np.float32(step) + np.float32(1.0)
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.to(torch.float32), m, grads)
        v = tree_map(
            lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.to(torch.float32)), v, grads
        )
        # bias corrections in float32, as the reference computes them
        mh_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** t))
        vh_scale = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t))

        def step_fn(p, mm, vv):
            upd = (mm * mh_scale) / (torch.sqrt(vv * vh_scale) + eps)
            return (p.to(torch.float32) - lr * upd).to(p.dtype)

        return tree_map(step_fn, params, m, v), (m, v)

    return Optimizer(init, update, f"adam(lr={lr})")
