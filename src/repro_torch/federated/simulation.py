"""Round metrics, run results and evaluation, shared by the engines."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.hfl import CommAccountant
from repro_torch.data.synthetic_health import Dataset
from repro_torch.federated.programs import as_program
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass
class RoundMetrics:
    cloud_round: int
    test_acc: float
    divergence: float
    mean_local_loss: float
    # host seconds since the previous history entry, and the simulated
    # seconds of the same rounds when the run models latency (WallClock)
    wall_seconds: float = 0.0
    sim_seconds: float = 0.0


@dataclasses.dataclass
class SimResult:
    history: List[RoundMetrics]
    accountant: CommAccountant
    final_params: dict
    wall_seconds: float = 0.0

    def rounds_to_accuracy(self, target: float) -> Optional[int]:
        for m in self.history:
            if m.test_acc >= target:
                return m.cloud_round
        return None

    def final_accuracy(self) -> float:
        return self.history[-1].test_acc if self.history else 0.0


@torch.no_grad()
def evaluate(params, program, test: Dataset, batch: int = 512) -> float:
    """Weighted mean of ``program.metric`` over the test set, in batches on
    the parameters' device."""
    program = as_program(program)
    device = tree_leaves(params)[0].device
    accs, ns = [], []
    for i in range(0, len(test), batch):
        x = torch.as_tensor(test.x[i : i + batch], device=device)
        y = torch.as_tensor(test.y[i : i + batch], device=device)
        accs.append(float(program.metric(params, x, y)) * len(y))
        ns.append(len(y))
    return float(np.sum(accs) / np.sum(ns))

