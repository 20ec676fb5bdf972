"""Parameter trees across the numpy boundary.

The reference package and this one meet only as numpy arrays: a test draws
the reference's initial parameters, turns them into numpy, and hands them
to the port through :func:`params_from_numpy`.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_numpy(tree, device="cpu") -> dict:
    """Nested mapping of array-likes -> nested dict of tensors on ``device``
    (dtype kept, values copied)."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def params_to_numpy(tree) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays (on the host)."""
    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
