"""Roofline terms of a dry-run pair, on the NVIDIA H100.

compute    = FLOPs / peak FLOP/s
memory     = bytes / HBM bandwidth
collective = collective bytes / link bandwidth

all per rank.  The port of ``src/repro/distributed/analysis.py``: where the
reference parses the partitioned HLO text for its collectives, the port
counts the collectives it issues (:class:`CollectiveCounter`, a dispatch
mode over ``torch.ops._c10d_functional``), and the dry run builds a
:class:`Roofline` from its own counts (the reference's
``roofline_from_compiled`` has no counterpart: there is no compiled
artifact).  The parameter counts are the reference's, formula for formula.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM per-card constants (the datasheet's dense figures, the
# ones PERF.md's kernel bounds use)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, fp32 (non-tensor)
HBM_BW = 3.35e12  # B/s, HBM3
# NVLink 4 on the H100 SXM: 900 GB/s per card, both directions together
# (the H100 datasheet); one direction is half of it
LINK_BW = 450e9  # B/s, one direction

# ``_c10d_functional`` collective -> the reference's HLO kind name
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


class CollectiveCounter(TorchDispatchMode):
    """Adds up, by the reference's kind names, the operand bytes of every
    ``_c10d_functional`` collective issued inside it (a DTensor's
    redistributions included: a DTensor operation is let through to its
    own dispatch first, which issues the collectives as local operations).
    ``bytes`` maps kind -> bytes; ``calls`` kind -> count."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(func._opname)
            if kind is not None:
                n = sum(t.numel() * t.element_size() for t in _tensors(args[0]))
                self.bytes[kind] = self.bytes.get(kind, 0) + n
                self.calls[kind] = self.calls.get(kind, 0) + 1
        return func(*args, **(kwargs or {}))


def collective_bytes(counter: CollectiveCounter) -> Dict[str, int]:
    """Bytes per collective kind that ``counter`` saw."""
    return dict(counter.bytes)


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: Dict[str, int]
    n_devices: int

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    @property
    def compute_s(self) -> float:
        # the counts are per rank
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        # ring-model byte multipliers: all-reduce = RS + AG = 2x payload;
        # others move ~1x their payload per device over one link
        weighted = 0.0
        for kind, b in self.coll_bytes.items():
            weighted += (2.0 if kind == "all-reduce" else 1.0) * b
        return weighted / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "coll_bytes": dict(self.coll_bytes),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops_per_token(cfg) -> float:
    """6 * N_active per token (dense approximation incl. MoE top-k)."""
    return 6.0 * active_params(cfg)


def active_params(cfg) -> float:
    """Parameter count with only top-k experts counted (active params)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    dh = cfg.d_head
    att = d * (cfg.n_heads * dh) + 2 * d * (cfg.n_kv_heads * dh) + (cfg.n_heads * dh) * d
    gate_mult = 3 if cfg.act == "swiglu" else 2
    dense_mlp = gate_mult * d * f
    total = 0.0
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "attn":
            total += att
        elif kind == "mamba":
            di = cfg.ssm.expand * d
            dt_rank = cfg.ssm.dt_rank or max(1, -(-d // 16))
            total += d * 2 * di + di * (dt_rank + 2 * cfg.ssm.d_state) + dt_rank * di + 2 * di * d
        else:  # rwkv
            total += 6 * d * d
        if cfg.is_moe_layer(i):
            total += cfg.moe.top_k * dense_mlp + d * cfg.moe.n_experts
        else:
            total += dense_mlp
    total += 2 * v * d if not cfg.tie_embeddings else v * d
    if cfg.family == "encdec":
        total += cfg.n_encoder_layers * (att + dense_mlp) + cfg.n_layers * att  # cross
    return float(total)


def total_params(cfg) -> float:
    """All parameters (every expert counted)."""
    if cfg.moe is None:
        return active_params(cfg)
    d, f = cfg.d_model, cfg.d_ff
    gate_mult = 3 if cfg.act == "swiglu" else 2
    per_expert = gate_mult * d * f
    extra = 0.0
    for i in range(cfg.n_layers):
        if cfg.is_moe_layer(i):
            extra += (cfg.moe.n_experts - cfg.moe.top_k) * per_expert
    return active_params(cfg) + extra
