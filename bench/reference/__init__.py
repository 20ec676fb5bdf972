"""Plain references of the benchmark's cells; nothing of the program is
imported here."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def fp32_products():
    """The library's TF32 off for the products inside: a reference's float32
    is float32, and a control's lower precision is its own explicit rounding."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
