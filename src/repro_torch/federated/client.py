"""Federated client: one EU's shard and its local-SGD hyperparameters.

Clients are stateless across rounds (fresh optimizer state per round: 1
local epoch, batch 10, Adam 1e-3 in the paper's setup).  Each epoch runs a
bucketed number of steps, the shard padded by resampling to fill the
bucket, so clients of one bucket train together in one cohort.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.data.synthetic_health import Dataset
from repro_torch.federated.programs import ClientProgram, as_program

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _bucket(steps: int) -> int:
    for b in _BUCKETS:
        if steps <= b:
            return b
    return _BUCKETS[-1]


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
