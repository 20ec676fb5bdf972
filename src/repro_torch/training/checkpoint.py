"""npz checkpoints of parameter trees, with a JSON manifest.

The port of ``src/repro/training/checkpoint.py``, in its file format, so a
checkpoint crosses between the two packages: flat keys are the leaves'
'/'-joined tree paths (dict keys, and tuple indices as integers:
``blocks/0/ffn/w_up/w``), the arrays go into one ``np.savez`` file, and
``<path>.json`` holds the step, the sorted keys, each key's shape and
dtype name, and an ``extra`` dict.

A bfloat16 leaf is written as the reference's ``np.savez`` writes an
``ml_dtypes.bfloat16`` array: numpy has no bfloat16, so the array header
says ``'<V2'`` (two raw bytes an element) and the bytes are the bf16 bit
patterns; the manifest names the dtype ``bfloat16``.  Loading views such
bytes back as bfloat16 (the reference's own ``load_checkpoint`` cannot:
numpy has no cast from ``V2``).  Loading casts every array to the dtype
of the matching leaf of ``reference_tree`` and puts it on that leaf's
device; a key the file lacks raises ``KeyError``, a shape that differs
``ValueError``.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten

_BF16_BYTES = np.dtype("V2")


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BYTES)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save_checkpoint(path: str, tree, step: int = 0, extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = dict(zip((_key(p) for p in tree_paths(tree)), tree_leaves(tree), strict=True))
    np.savez(path, **{k: _to_numpy(t) for k, t in leaves.items()})
    manifest = {
        "step": step,
        "keys": sorted(leaves),
        "shapes": {k: list(t.shape) for k, t in leaves.items()},
        "dtypes": {k: _dtype_name(t) for k, t in leaves.items()},
        "extra": extra or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype == _BF16_BYTES:  # bf16 bit patterns
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=like.device, dtype=like.dtype)


def load_checkpoint(path: str, reference_tree: Any) -> Any:
    """The tree saved at ``path`` (``.npz`` optional), in
    ``reference_tree``'s structure, dtypes and devices."""
    paths = tree_paths(reference_tree)
    refs = tree_leaves(reference_tree)
    keys = [_key(p) for p in paths]
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        missing = sorted(set(keys) - set(data.files))
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]} ...")
        arrays = {k: data[k] for k in keys}
    for k, ref in zip(keys, refs):
        if arrays[k].shape != tuple(ref.shape):
            raise ValueError(f"{k}: shape {arrays[k].shape} != {tuple(ref.shape)}")
    return tree_unflatten(paths, [_to_tensor(arrays[k], ref) for k, ref in zip(keys, refs)])
