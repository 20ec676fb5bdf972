"""Federated client: local training on a private shard (paper eq. 4-5).

Clients are stateless across rounds (fresh optimizer state per round: 1
local epoch, batch 10, Adam 1e-3 in the paper's setup).  Each epoch runs a
bucketed number of steps, the shard padded by resampling to fill the
bucket, so clients of one bucket train together in one cohort in the
engines.  ``FLClient.local_update`` is the readable simulator's form: one
client's epochs, one model, the same batch draws as the engines'.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic_health import Dataset
from repro_torch.federated.programs import ClientProgram, as_program
from repro_torch.utils.tree import tree_leaves, tree_ravel, tree_spec, tree_unravel

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _bucket(steps: int) -> int:
    for b in _BUCKETS:
        if steps <= b:
            return b
    return _BUCKETS[-1]


def _local_epoch(params, xb, yb, program: ClientProgram, n_steps: int, lr: float):
    """One optimizer pass over ``n_steps`` batches of one model.

    xb: (n_steps, B, *feat), yb: (n_steps, B), on the parameters' device.
    The optimizer is the program's (``make_optimizer``: Adam for FedAvg,
    SGD for FedSGD), with fresh state.  Both are elementwise, so they step
    the parameters as one flat row (a few operations per step rather than a
    few per leaf), which is the same arithmetic as stepping each leaf; the
    loss sees the row split back into the tree.  Returns the new parameters
    and the mean of the steps' losses (a 0-d tensor).
    """
    spec = tree_spec(params)
    opt = program.make_optimizer(lr)
    p = tree_ravel(params)[0].detach()
    state = opt.init(p)
    losses = []
    for s in range(n_steps):
        p.requires_grad_(True)
        loss = program.loss(tree_unravel(spec, p), xb[s], yb[s])
        (grad,) = torch.autograd.grad(loss, p)
        with torch.no_grad():
            p, state = opt.update(p.detach(), grad, state, s)
        losses.append(loss.detach())
    return tree_unravel(spec, p.detach()), torch.stack(losses).mean()


@dataclasses.dataclass
class FLClient:
    """One EU with its local dataset shard and its own hyperparameters.

    ``local_epochs=None`` follows the schedule's ``local_steps``.
    """

    cid: int
    shard: Dataset
    program: ClientProgram
    batch_size: int = 10
    lr: float = 1e-3
    max_steps: int = 128
    local_epochs: Optional[int] = None

    def __post_init__(self):
        self.program = as_program(self.program)
        if self.local_epochs is not None and self.local_epochs < 1:
            raise ValueError(f"local_epochs must be >= 1, got {self.local_epochs}")

    @property
    def data_size(self) -> int:
        return len(self.shard)

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.shard.y, minlength=self.shard.n_classes)

    def plan_steps(self) -> int:
        """Bucketed steps one local epoch runs on this shard (0 = empty)."""
        n = len(self.shard)
        if n == 0:
            return 0
        if self.program.single_step:
            return 1
        return _bucket(max(1, min(self.max_steps, int(np.ceil(n / self.batch_size)))))

    def epochs_for(self, schedule_epochs: int) -> int:
        """Local epochs this round: the client override, else the schedule's."""
        if self.program.single_step:
            return 1
        return self.local_epochs if self.local_epochs is not None else schedule_epochs

    def local_update(self, params, rng: np.random.Generator, epochs: int = 1) -> Tuple[Dict, float]:
        """Train locally from ``params``; returns (new params, the LAST
        epoch's mean step loss).

        ``epochs`` is the schedule's; the client's ``local_epochs`` and a
        ``single_step`` program override it, as in the engines.  Each epoch
        draws one permutation of the shard (plus resampled padding) from
        ``rng``, the draws of ``engine.cohort.draw_batch_indices``.
        """
        n = len(self.shard)
        if n == 0:
            return params, 0.0
        steps = self.plan_steps()
        epochs = self.epochs_for(epochs)
        device = tree_leaves(params)[0].device
        loss = 0.0
        for _ in range(epochs):
            idx = rng.permutation(n)
            need = steps * self.batch_size
            if need > n:  # pad by resampling
                idx = np.concatenate([idx, rng.integers(0, n, need - n)])
            idx = idx[:need].reshape(steps, self.batch_size)
            xb = torch.as_tensor(self.shard.x[idx], device=device)
            yb = torch.as_tensor(self.shard.y[idx], device=device)
            params, l = _local_epoch(params, xb, yb, self.program, steps, self.lr)
            loss = float(l)
        return params, loss
