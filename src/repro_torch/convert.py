"""Parameter trees across the numpy boundary.

The reference package and this one meet only as numpy arrays: a test draws
the reference's parameters, turns them into numpy, and hands them to the
port through :func:`params_from_numpy`.  Trees are nested mappings, tuples
and lists (a transformer's ``params["blocks"]`` is a tuple).  bfloat16
arrays come out of JAX as ``ml_dtypes.bfloat16``, which ``torch.tensor``
does not take; they cross by a bit view (uint16 <-> ``torch.bfloat16``), so
a round trip is exact.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_numpy(tree, device="cpu"):
    """Nested mappings/tuples/lists of array-likes -> the same nesting (dicts
    for mappings) of tensors on ``device``, dtype kept, values copied."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def params_to_numpy(tree):
    """Nested mappings/tuples/lists of tensors -> the same nesting of numpy
    arrays on the host; bfloat16 tensors become ``ml_dtypes.bfloat16``
    arrays, as JAX's are."""
    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only needed for bf16 trees, which come from JAX

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
