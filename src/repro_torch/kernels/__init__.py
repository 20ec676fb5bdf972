"""Hand-written CUDA kernels of the port, each beside its plain version.

============================  ==============================================  ==================================
kernel                        replaces (reference Pallas kernel)              CUDA source (``csrc/``)
============================  ==============================================  ==================================
``hier_segment_aggregate``    ``src/repro/kernels/segment_aggregate.py``      ``aggregate.cu``
``hier_aggregate``            ``src/repro/kernels/hier_aggregate.py``         ``aggregate.cu``
``flash_attention``           ``src/repro/kernels/flash_attention.py``        ``flash_attention.cu``
``topk_gating``               ``src/repro/kernels/topk_gating.py``            ``topk_gating.cu``
============================  ==============================================  ==================================

All four are built into one library, ``build/repro_torch/librepro_torch-<hash>.so``
(``build.py``).  ``topk_gating`` has no caller on a model path: the
reference's MoE router does not call its kernel either.
"""
from typing import Dict

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.hier_aggregate import hier_aggregate, hier_aggregate_ref
from repro_torch.kernels.segment_aggregate import (
    hier_segment_aggregate,
    hier_segment_aggregate_ref,
)
from repro_torch.kernels.topk_gating import topk_gating, topk_gating_ref

KERNELS = (hier_segment_aggregate, hier_aggregate, flash_attention, topk_gating)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
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
