"""Hand-written CUDA kernels of the port, each beside its plain version.

============================  ==============================================
kernel                        replaces (reference Pallas kernel)
============================  ==============================================
``hier_segment_aggregate``    ``src/repro/kernels/segment_aggregate.py``
``hier_aggregate``            ``src/repro/kernels/hier_aggregate.py``
============================  ==============================================

The reference's ``flash_attention`` and ``topk_gating`` serve the sequence
models, which this port does not carry yet (ROADMAP.md Queue 2).
"""
from typing import Dict

from repro_torch.kernels.hier_aggregate import hier_aggregate, hier_aggregate_ref
from repro_torch.kernels.segment_aggregate import (
    hier_segment_aggregate,
    hier_segment_aggregate_ref,
)

KERNELS = (hier_segment_aggregate, hier_aggregate)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "hier_aggregate",
    "hier_aggregate_ref",
    "hier_segment_aggregate",
    "hier_segment_aggregate_ref",
    "launch_counts",
    "reset_launch_counts",
]
