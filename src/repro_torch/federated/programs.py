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
  "lm"     small causal dense transformer LM (``models.transformer``) on
           (seq_len,) int32 token shards, next-token loss and accuracy
  "moe"    the same LM with top-k routed expert banks (``models.moe``),
           its router's load-balance and z losses added to the loss
  "mamba"  a hybrid LM: one attention layer, then Mamba (S6) mixers
           (``models.mamba``)
  "rwkv"   an RWKV-6 LM: linear attention with data-dependent decay
           (``models.rwkv``)
  "fedsgd" wrapper around any of them: one plain-SGD step per round and a
           gradient uplink (``base="cnn"``, ``grad_bits=32``)
  ======== ==========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.cnn1d import HEARTBEAT_CNN, CNNConfig, cnn_apply, cnn_apply_cohort, cnn_init
from repro_torch.models.config import ModelConfig, MoEConfig, RWKVConfig, SSMConfig
from repro_torch.models.modules import dense, dense_init
from repro_torch.models.transformer import forward as transformer_forward
from repro_torch.models.transformer import init_params as transformer_init
from repro_torch.training.loss import accuracy, lm_loss, softmax_nll, softmax_xent
from repro_torch.training.optimizers import Optimizer, adam, sgd
from repro_torch.utils.registry import Registry
from repro_torch.utils.tree import tree_map

PROGRAMS = Registry("client_program")

# program names that train on (seq_len,) int32 token shards (build_scenario
# routes them to the topic-skewed token-stream population)
SEQUENCE_PROGRAMS = ("lm", "moe", "mamba", "rwkv")


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
        if not self.cohort_is_mapped(impl):
            return softmax_nll(self.apply_cohort(params, x), y).mean(dim=-1)
        return torch.func.vmap(lambda p, xb, yb: self.loss(p, xb, yb, impl=impl))(params, x, y)

    def cohort_is_mapped(self, impl: str) -> bool:
        """True when :meth:`cohort_loss` maps :meth:`loss` over the clients
        (``torch.func.vmap``) for this ``impl``, False when it runs one
        batched form.  ``Telemetry.jit_cost`` counts a mapped cohort at one
        client and scales by C: torch's flop formula for a convolution's
        backward ignores the groups vmap gives it."""
        return impl != "gemm"

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

    def cohort_loss(self, params, x, y, *, impl: str = "gemm"):
        return self.base.cohort_loss(params, x, y, impl=impl)

    def cohort_is_mapped(self, impl: str) -> bool:
        return self.base.cohort_is_mapped(impl)

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


def tiny_lm_config(
    vocab_size: int = 128,
    seq_len: int = 32,
    d_model: int = 32,
    n_layers: int = 2,
    n_heads: int = 2,
    d_ff: int = 64,
) -> ModelConfig:
    """A causal transformer sized for federated IoT clients (20,640
    parameters at the defaults).  fp32 with tied embeddings: FedAvg averages
    flat fp32 rows, and attention runs the plain path (``use_flash=False``),
    since training needs a gradient and the flash kernel defines none."""
    return ModelConfig(
        name=f"lm-tiny-v{vocab_size}-d{d_model}",
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=d_ff,
        vocab_size=vocab_size,
        act="gelu",
        tie_embeddings=True,
        max_seq=seq_len,
        dtype="float32",
    )


def tiny_moe_config(
    vocab_size: int = 128,
    seq_len: int = 32,
    d_model: int = 32,
    n_layers: int = 2,
    n_heads: int = 2,
    d_ff: int = 32,
    n_experts: int = 4,
    top_k: int = 2,
) -> ModelConfig:
    """The mixture-of-experts LM sized for federated IoT clients: every
    layer's feed-forward block a top-k routed bank of SwiGLU experts.  At
    cohort token counts (under 4096 per client and call) it takes the
    dense dispatch, whose shapes are static, so the mapped cohort epoch
    sees no data-dependent shape."""
    return ModelConfig(
        name=f"moe-tiny-v{vocab_size}-d{d_model}-e{n_experts}",
        family="moe",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=d_ff,
        vocab_size=vocab_size,
        moe=MoEConfig(n_experts=n_experts, top_k=top_k),
        tie_embeddings=True,
        max_seq=seq_len,
        dtype="float32",
    )


def tiny_mamba_config(
    vocab_size: int = 128,
    seq_len: int = 32,
    d_model: int = 32,
    n_layers: int = 2,
    n_heads: int = 2,
    d_ff: int = 64,
    d_state: int = 8,
    d_conv: int = 4,
    expand: int = 2,
) -> ModelConfig:
    """A jamba-style hybrid LM sized for federated IoT clients: the whole
    stack is one block (``hybrid_block = n_layers``), so one attention
    layer anchors ``n_layers - 1`` Mamba (S6) mixers.  The recurrent state
    lives inside the chunked scan of each mixer, so the federated layers
    see an ordinary (B, S) -> logits forward."""
    return ModelConfig(
        name=f"mamba-tiny-v{vocab_size}-d{d_model}",
        family="hybrid",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=d_ff,
        vocab_size=vocab_size,
        ssm=SSMConfig(d_state=d_state, d_conv=d_conv, expand=expand),
        hybrid_block=n_layers,
        act="gelu",
        tie_embeddings=True,
        max_seq=seq_len,
        dtype="float32",
    )


def tiny_rwkv_config(
    vocab_size: int = 128,
    seq_len: int = 32,
    d_model: int = 32,
    n_layers: int = 2,
    d_ff: int = 64,
    head_size: int = 16,
) -> ModelConfig:
    """An RWKV-6 "Finch" LM sized for federated IoT clients (``d_model`` a
    multiple of ``head_size``).  As with the Mamba config, the chunked
    recurrence is internal to the mixer."""
    return ModelConfig(
        name=f"rwkv-tiny-v{vocab_size}-d{d_model}",
        family="ssm",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=max(1, d_model // head_size),
        n_kv_heads=max(1, d_model // head_size),
        d_ff=d_ff,
        vocab_size=vocab_size,
        rwkv=RWKVConfig(head_size=head_size),
        act="gelu",
        tie_embeddings=True,
        max_seq=seq_len,
        dtype="float32",
    )


@dataclasses.dataclass(frozen=True)
class SequenceProgram(ClientProgram):
    """Token-sequence LM programs over ``models.transformer``.

    Shards hold (N, seq_len) int32 token sequences and the training signal
    is next-token prediction on the sequence itself, so the ``Dataset``
    label ``y`` carries the sequence's TOPIC, which only the KLD-aware
    assignment reads (``n_classes`` is the topic count).  The cohort form
    maps :meth:`loss` over the C clients for every ``impl``: the base
    class's batched form would score ``y`` as a class label.  Subclasses
    choose the config and may add loss terms from the forward's aux dict
    (:meth:`_aux_loss`).  :meth:`apply_cohort` (the distillation fuse's
    batched forward) maps :meth:`apply` over the C models.
    """

    cfg: ModelConfig = dataclasses.field(default_factory=tiny_lm_config)
    seq_len: int = 32
    n_topics: int = 4

    def init(self, generator: torch.Generator) -> dict:
        return transformer_init(generator, self.cfg)

    def apply(self, params, x, *, impl: str | None = None):
        del impl  # one formulation
        return transformer_forward(params, self.cfg, x)[0]

    def apply_cohort(self, params, x):
        return torch.func.vmap(lambda p, xb: self.apply(p, xb))(params, x)

    def _aux_loss(self, aux):
        """Auxiliary loss terms from the forward's aux dict; None = none."""
        del aux
        return None

    def loss(self, params, x, y, *, impl: str | None = None):
        del y, impl  # the topic label is an assignment-time signal only
        logits, aux = transformer_forward(params, self.cfg, x)
        base = lm_loss(logits, x, shift=True)
        extra = self._aux_loss(aux)
        return base if extra is None else base + extra

    def cohort_loss(self, params, x, y, *, impl: str = "gemm"):
        return torch.func.vmap(lambda p, xb, yb: self.loss(p, xb, yb))(params, x, y)

    def cohort_is_mapped(self, impl: str) -> bool:
        return True

    def metric(self, params, x, y):
        """Next-token accuracy (the labels are the input shifted by one)."""
        del y
        return accuracy(self.apply(params, x)[:, :-1], x[:, 1:])

    @property
    def feat_shape(self) -> Tuple[int, ...]:
        return (self.seq_len,)

    @property
    def feat_dtype(self):
        return np.int32

    @property
    def n_classes(self) -> int:
        return self.n_topics


@dataclasses.dataclass(frozen=True)
class LMProgram(SequenceProgram):
    """Small causal dense-transformer LM on token shards."""

    @property
    def name(self) -> str:
        return "lm"


@dataclasses.dataclass(frozen=True)
class MoEProgram(SequenceProgram):
    """Mixture-of-experts LM: top-k softmax routing, dense dispatch at
    cohort sizes.  The router's Switch load-balance loss and z-loss join the
    next-token loss (``aux_weight`` / ``z_weight``), so the router's health
    travels with the federated updates like any other gradient."""

    cfg: ModelConfig = dataclasses.field(default_factory=tiny_moe_config)
    aux_weight: float = 1e-2
    z_weight: float = 1e-3

    @property
    def name(self) -> str:
        return "moe"

    def _aux_loss(self, aux):
        return self.aux_weight * aux["moe_aux"] + self.z_weight * aux["moe_z"]


@dataclasses.dataclass(frozen=True)
class MambaProgram(SequenceProgram):
    """Hybrid attention + Mamba (S6) LM.  The selective scan's state is made
    and consumed inside each mixer, so rounds exchange only parameters."""

    cfg: ModelConfig = dataclasses.field(default_factory=tiny_mamba_config)

    @property
    def name(self) -> str:
        return "mamba"


@dataclasses.dataclass(frozen=True)
class RWKVProgram(SequenceProgram):
    """RWKV-6 linear-attention LM: a chunked recurrence with a carried
    per-head state matrix, internal to the forward as Mamba's is."""

    cfg: ModelConfig = dataclasses.field(default_factory=tiny_rwkv_config)

    @property
    def name(self) -> str:
        return "rwkv"


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


@PROGRAMS.register("lm")
def _lm_program(vocab_size: int = 128, seq_len: int = 32, n_topics: int = 4, **cfg_kw) -> LMProgram:
    cfg = tiny_lm_config(vocab_size=vocab_size, seq_len=seq_len, **cfg_kw)
    return LMProgram(cfg=cfg, seq_len=seq_len, n_topics=n_topics)


@PROGRAMS.register("moe")
def _moe_program(
    vocab_size: int = 128,
    seq_len: int = 32,
    n_topics: int = 4,
    aux_weight: float = 1e-2,
    z_weight: float = 1e-3,
    **cfg_kw,
) -> MoEProgram:
    cfg = tiny_moe_config(vocab_size=vocab_size, seq_len=seq_len, **cfg_kw)
    return MoEProgram(cfg=cfg, seq_len=seq_len, n_topics=n_topics, aux_weight=aux_weight, z_weight=z_weight)


@PROGRAMS.register("mamba")
def _mamba_program(vocab_size: int = 128, seq_len: int = 32, n_topics: int = 4, **cfg_kw) -> MambaProgram:
    cfg = tiny_mamba_config(vocab_size=vocab_size, seq_len=seq_len, **cfg_kw)
    return MambaProgram(cfg=cfg, seq_len=seq_len, n_topics=n_topics)


@PROGRAMS.register("rwkv")
def _rwkv_program(vocab_size: int = 128, seq_len: int = 32, n_topics: int = 4, **cfg_kw) -> RWKVProgram:
    cfg = tiny_rwkv_config(vocab_size=vocab_size, seq_len=seq_len, **cfg_kw)
    return RWKVProgram(cfg=cfg, seq_len=seq_len, n_topics=n_topics)


@PROGRAMS.register("fedsgd")
def _fedsgd_program(base: str = "cnn", grad_bits: int = 32, **base_kw) -> FedSGDProgram:
    """Wrap a registered base program: ``PROGRAMS.get("fedsgd")(base="mlp")``."""
    return FedSGDProgram(base=PROGRAMS.get(base)(**base_kw), grad_bits=grad_bits)
