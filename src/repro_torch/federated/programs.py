"""Client programs: what one EU trains, behind one interface.

A ``ClientProgram`` bundles what the HFL machinery needs to know about a
workload: ``init`` (fresh parameters), ``apply`` (logits of one model),
``loss`` / ``metric``, the cohort form ``cohort_loss`` (per-client mean
losses of C stacked models), the distillation logits (``apply_logits``
and its batched ``apply_logits_cohort``), the local optimizer
(``make_optimizer``, ``single_step``), the uplink payload and its
transform (``uplink_bits``, ``quantize_upload``) and the feature layout.  Programs are frozen
dataclasses, so equal configs are equal programs.

``PROGRAMS`` (a ``utils.registry.Registry``) maps names to factories:

  ======== ==========================================================
  name     workload
  ======== ==========================================================
  "cnn"    the paper's 1-D CNN (both convolution forms)
  "mlp"    flattened-feature classifier (``models.modules.dense``)
  "fedsgd" wrapper around either: one plain-SGD step per round and a
           gradient uplink (``base="cnn"``, ``grad_bits=32``)
  ======== ==========================================================

The reference's sequence LMs ("lm", "moe", "mamba", "rwkv") are queued in
ROADMAP.md (Queue 1, sequence models).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.cnn1d import HEARTBEAT_CNN, CNNConfig, cnn_apply, cnn_apply_cohort, cnn_init
from repro_torch.models.modules import dense, dense_init
from repro_torch.training.loss import accuracy, softmax_nll, softmax_xent
from repro_torch.training.optimizers import Optimizer, adam, sgd
from repro_torch.utils.registry import Registry
from repro_torch.utils.tree import tree_map

PROGRAMS = Registry("client_program")


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

    def apply_logits(self, params, x, *, impl: str | None = None):
        """Logits for knowledge distillation (``engine.distill``), softened
        over the last axis; programs fused at one edge must emit one logit
        alphabet.  Defaults to the training forward."""
        return self.apply(params, x, impl=impl)

    def apply_logits_cohort(self, params, x):
        """:meth:`apply_logits` of C stacked models at once (the flat fuse's
        batched forward); defaults to :meth:`apply_cohort`."""
        return self.apply_cohort(params, x)

    def loss(self, params, x, y, *, impl: str | None = None):
        """Mean training loss of a batch (classifier cross entropy)."""
        return softmax_xent(self.apply(params, x, impl=impl), y)

    def cohort_loss(self, params, x, y, *, impl: str = "gemm"):
        """(C,) mean loss of each client's batch.  The clients share no
        parameter, so the gradient of the SUM is each client's own.

        ``impl="gemm"`` runs :meth:`apply_cohort` (the device pipeline's
        form); any other value maps :meth:`loss` with that ``impl`` over
        the C clients (``torch.func.vmap``: for the CNN's "xla", one
        grouped library convolution per layer)."""
        if impl == "gemm":
            return softmax_nll(self.apply_cohort(params, x), y).mean(dim=-1)
        return torch.func.vmap(lambda p, xb, yb: self.loss(p, xb, yb, impl=impl))(params, x, y)

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

    def quantize_upload(self, start, trained):
        """Transform the uploaded update; identity by default.  Leaf-wise, so
        callers may pass parameter trees or flat rows."""
        del start
        return trained

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


@dataclasses.dataclass(frozen=True)
class MLPProgram(ClientProgram):
    """Flattened-feature MLP classifier: dense -> gelu -> dense.

    Runs on the CNN's ``(L, Ch)`` float shards (the forward flattens), so
    every CNN scenario is also an MLP scenario.  The GeLU is the tanh
    approximation, ``jax.nn.gelu``'s default.
    """

    feat: Tuple[int, ...] = (187, 1)
    classes: int = 5
    hidden: int = 64

    @property
    def name(self) -> str:
        return "mlp"

    @property
    def d_in(self) -> int:
        return int(np.prod(self.feat))

    def init(self, generator: torch.Generator) -> dict:
        return {
            "fc1": dense_init(generator, self.d_in, self.hidden, torch.float32, bias=True),
            "fc2": dense_init(generator, self.hidden, self.classes, torch.float32, bias=True),
        }

    def apply(self, params, x, *, impl: str | None = None):
        del impl  # one formulation
        h = x.reshape(x.shape[0], -1)
        h = F.gelu(dense(params["fc1"], h), approximate="tanh")
        return dense(params["fc2"], h)

    def apply_cohort(self, params, x):
        """C models as two batched products over the leading C axis."""
        h = x.reshape(x.shape[0], x.shape[1], -1)
        h = torch.bmm(h, params["fc1"]["w"]) + params["fc1"]["b"][:, None, :]
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, params["fc2"]["w"]) + params["fc2"]["b"][:, None, :]

    @property
    def feat_shape(self) -> Tuple[int, ...]:
        return tuple(self.feat)

    @property
    def n_classes(self) -> int:
        return self.classes


@dataclasses.dataclass(frozen=True)
class FedSGDProgram(ClientProgram):
    """FedSGD over a base program: ONE plain-SGD step per round.

    Each participating EU takes one mini-batch gradient step from the edge
    model (``single_step``: steps and epochs both become 1), with plain SGD
    in place of Adam (``make_optimizer``), so the uploaded delta is
    ``-lr * gradient``.  The uplink is a gradient payload of ``grad_bits``
    bits per parameter: 32 is exact; 16 casts the delta through fp16, and
    the cast is applied to the update, not only counted.
    """

    base: ClientProgram = dataclasses.field(default_factory=CNNProgram)
    grad_bits: int = 32

    def __post_init__(self):
        if self.grad_bits not in (16, 32):
            raise ValueError(f"grad_bits must be 16 or 32, got {self.grad_bits}")
        if isinstance(self.base, FedSGDProgram):
            raise TypeError("FedSGDProgram cannot wrap another FedSGDProgram")

    @property
    def name(self) -> str:
        return f"fedsgd-{self.base.name}"

    def init(self, generator: torch.Generator) -> dict:
        return self.base.init(generator)

    def apply(self, params, x, *, impl: str | None = None):
        return self.base.apply(params, x, impl=impl)

    def apply_cohort(self, params, x):
        return self.base.apply_cohort(params, x)

    def apply_logits(self, params, x, *, impl: str | None = None):
        return self.base.apply_logits(params, x, impl=impl)

    def apply_logits_cohort(self, params, x):
        return self.base.apply_logits_cohort(params, x)

    def loss(self, params, x, y, *, impl: str | None = None):
        return self.base.loss(params, x, y, impl=impl)

    def metric(self, params, x, y):
        return self.base.metric(params, x, y)

    @property
    def feat_shape(self) -> Tuple[int, ...]:
        return self.base.feat_shape

    @property
    def feat_dtype(self):
        return self.base.feat_dtype

    @property
    def n_classes(self) -> int:
        return self.base.n_classes

    @property
    def single_step(self) -> bool:
        return True

    def make_optimizer(self, lr: float) -> Optimizer:
        return sgd(lr=lr)

    def uplink_bits(self, model_bits: float) -> float:
        return model_bits * (self.grad_bits / 32.0)

    @property
    def quantizes_upload(self) -> bool:
        return self.grad_bits < 32

    def quantize_upload(self, start, trained):
        """fp16 round trip of the update delta, leaf by leaf (trees and flat
        rows alike); exact passthrough at ``grad_bits=32``."""
        if self.grad_bits >= 32:
            return trained
        return tree_map(lambda s, t: s + (t - s).to(torch.float16).to(t.dtype), start, trained)


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


@PROGRAMS.register("cnn")
def _cnn_program(cfg: CNNConfig = HEARTBEAT_CNN) -> CNNProgram:
    return CNNProgram(cfg)


@PROGRAMS.register("mlp")
def _mlp_program(feat: Tuple[int, ...] = (187, 1), n_classes: int = 5, hidden: int = 64) -> MLPProgram:
    return MLPProgram(feat=tuple(feat), classes=n_classes, hidden=hidden)


@PROGRAMS.register("fedsgd")
def _fedsgd_program(base: str = "cnn", grad_bits: int = 32, **base_kw) -> FedSGDProgram:
    """Wrap a registered base program: ``PROGRAMS.get("fedsgd")(base="mlp")``."""
    return FedSGDProgram(base=PROGRAMS.get(base)(**base_kw), grad_bits=grad_bits)
