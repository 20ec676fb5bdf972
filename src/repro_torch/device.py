"""The port's one device rule.

Entry points default to ``device="cuda"``.  Without CUDA they raise rather
than fall back to the CPU, because a silent fallback would report CPU
numbers as the card's; callers that want the CPU (the tests, the card-vs-CPU
check) ask for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` ("cuda", "cuda:N", "cpu" or a ``torch.device``) -> device.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    available, and ``ValueError`` for any other device type.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device must be 'cuda' or 'cpu', got {str(device)!r}")


def configure_numerics(device: torch.device) -> None:
    """Full float32 in matrix products and convolutions on the card.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and would put the card's trajectory outside the
    tolerances that hold it to the CPU run and to the reference.  bf16
    products may by default reduce partial sums in bf16; the reference
    accumulates them in fp32 (``preferred_element_type``), so that is off
    too.
    """
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
