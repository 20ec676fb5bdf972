"""Hand-written CUDA kernels of the port, each beside its plain version.

============================  ==============================================  ==========================================
kernel                        replaces (reference Pallas kernel)              CUDA source (``csrc/``)
============================  ==============================================  ==========================================
``hier_segment_aggregate``    ``src/repro/kernels/segment_aggregate.py``      ``aggregate.cu``
``hier_aggregate``            ``src/repro/kernels/hier_aggregate.py``         ``aggregate.cu``
``flash_attention``           ``src/repro/kernels/flash_attention.py``        bf16: ``flash_attention_sm90.cu`` (wgmma,
                                                                              TMA); fp32: ``flash_attention.cu`` (SIMT)
``topk_gating``               ``src/repro/kernels/topk_gating.py``            ``topk_gating.cu`` (8-lane groups for E <= 56,
                                                                              one row per warp with REDUX above)
``adam_update_``              none: the reference's Adam is ``jnp``, fused    ``adam.cu`` (one in-place pass a leaf)
                              by XLA
============================  ==============================================  ==========================================

All are built into one library, ``build/repro_torch/librepro_torch-<hash>.so``
(``build.py``).  ``topk_gating`` has no caller on a model path: the
reference's MoE router does not call its kernel either.  ``adam_update_``
is ``adam(...).update_``'s on CUDA, and counts under ``"adam_update"``.
``flash_attention.launches_by_variant`` counts its launches per kernel
(``"wgmma"``, ``"simt"``) beside the total in ``launch_counts()``.
"""
from typing import Dict

from repro_torch.kernels.adam import adam_update_, adam_update_ref_
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.hier_aggregate import hier_aggregate, hier_aggregate_ref
from repro_torch.kernels.segment_aggregate import (
    hier_segment_aggregate,
    hier_segment_aggregate_ref,
)
from repro_torch.kernels.topk_gating import topk_gating, topk_gating_ref

KERNELS = (hier_segment_aggregate, hier_aggregate, flash_attention, topk_gating, adam_update_)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`,
    keyed by its wrapper's name (an in-place wrapper's without its
    trailing underscore)."""
    return {k.__name__.rstrip("_"): k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for variant in flash_attention.launches_by_variant:
        flash_attention.launches_by_variant[variant] = 0


__all__ = [
    "KERNELS",
    "adam_update_",
    "adam_update_ref_",
    "flash_attention",
    "flash_attention_ref",
    "hier_aggregate",
    "hier_aggregate_ref",
    "hier_segment_aggregate",
    "hier_segment_aggregate_ref",
    "launch_counts",
    "reset_launch_counts",
    "topk_gating",
    "topk_gating_ref",
]
