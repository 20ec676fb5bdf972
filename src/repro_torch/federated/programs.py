"""Client programs: what one EU trains, behind one interface.

A ``ClientProgram`` bundles what the HFL machinery needs to know about a
workload: ``init`` (fresh parameters), ``apply`` (logits of one model),
``loss`` / ``metric``, the cohort form ``cohort_loss`` (per-client mean
losses of C stacked models), the local optimizer, the uplink payload and
the feature layout.  Programs are frozen dataclasses, so equal configs are
equal programs.

This slice of the port carries the paper's CNN only; the reference's MLP,
sequence LMs and FedSGD wrapper are queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.models.cnn1d import HEARTBEAT_CNN, CNNConfig, cnn_apply, cnn_apply_cohort, cnn_init
from repro_torch.training.loss import accuracy, softmax_nll, softmax_xent
from repro_torch.training.optimizers import Optimizer, adam


@dataclasses.dataclass(frozen=True)
class ClientProgram:
    """Base class; subclasses add frozen config fields and override hooks.

    ``impl`` selects between numerically distinct forward formulations of
    one model (the CNN's "xla" and "gemm" convolutions); ``None`` means the
    program's default.
    """

    @property
    def name(self) -> str:
        raise NotImplementedError

    def init(self, generator: torch.Generator) -> dict:
        raise NotImplementedError

    def apply(self, params, x, *, impl: str | None = None):
        raise NotImplementedError

    def apply_cohort(self, params, x):
        """Logits of C models at once: params stacked on a leading axis C,
        x: (C, B, *feat) -> (C, B, K)."""
        raise NotImplementedError

    def loss(self, params, x, y, *, impl: str | None = None):
        """Mean training loss of a batch (classifier cross entropy)."""
        return softmax_xent(self.apply(params, x, impl=impl), y)

    def cohort_loss(self, params, x, y):
        """(C,) mean loss of each client's batch.  The clients share no
        parameter, so the gradient of the SUM is each client's own."""
        return softmax_nll(self.apply_cohort(params, x), y).mean(dim=-1)

    def metric(self, params, x, y):
        """Mean per-example eval metric (classification accuracy)."""
        return accuracy(self.apply(params, x), y)

    def make_optimizer(self, lr: float) -> Optimizer:
        """Local optimizer for one round (fresh state per round)."""
        return adam(lr=lr)

    @property
    def single_step(self) -> bool:
        return False

    def uplink_bits(self, model_bits: float) -> float:
        """Bits one EU->edge upload costs (the full model)."""
        return model_bits

    @property
    def quantizes_upload(self) -> bool:
        return False

    @property
    def feat_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def feat_dtype(self):
        return np.float32

    @property
    def n_classes(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class CNNProgram(ClientProgram):
    """The paper's 1-D CNN classifier (``models.cnn1d``): "xla" convolution
    by default, "gemm" in the cohort step."""

    cfg: CNNConfig = HEARTBEAT_CNN

    @property
    def name(self) -> str:
        return "cnn"

    def init(self, generator: torch.Generator) -> dict:
        return cnn_init(generator, self.cfg)

    def apply(self, params, x, *, impl: str | None = None):
        return cnn_apply(params, self.cfg, x, conv_impl=impl or "xla")

    def apply_cohort(self, params, x):
        return cnn_apply_cohort(params, self.cfg, x)

    @property
    def feat_shape(self) -> Tuple[int, ...]:
        return (self.cfg.seq_len, self.cfg.in_channels)

    @property
    def n_classes(self) -> int:
        return self.cfg.n_classes


def group_clients(clients, fallback=None):
    """Partition clients by program (value equality): the distinct programs
    in first-appearance order and an (M,) client -> group index array."""
    programs: list = []
    group_of = np.zeros(len(clients), np.int64)
    for i, c in enumerate(clients):
        try:
            gi = programs.index(c.program)
        except ValueError:
            gi = len(programs)
            programs.append(c.program)
        group_of[i] = gi
    if not programs:
        programs = [as_program(fallback)]
    return programs, group_of


def group_edge_sizes(clients, assignment, group_of) -> list:
    """Per-group cloud weights: each edge's data volume of that group's
    clients, floored at 1 so empty (edge, group) cells stay defined."""
    assignment = np.asarray(assignment)
    n = assignment.shape[1]
    n_groups = int(group_of.max()) + 1 if len(group_of) else 1
    return [
        np.asarray(
            [
                max(
                    sum(
                        c.data_size
                        for i, c in enumerate(clients)
                        if assignment[i, j] and group_of[i] == g
                    ),
                    1,
                )
                for j in range(n)
            ],
            np.float32,
        )
        for g in range(n_groups)
    ]


def as_program(obj) -> ClientProgram:
    """A ``ClientProgram`` as it is, or a bare ``CNNConfig`` as its CNN."""
    if isinstance(obj, ClientProgram):
        return obj
    if isinstance(obj, CNNConfig):
        return CNNProgram(obj)
    raise TypeError(f"expected a ClientProgram (or CNNConfig), got {type(obj).__name__}")
