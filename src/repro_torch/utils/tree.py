"""Parameter trees: nested dicts and tuples of tensors, flattened in JAX's
leaf order.

JAX flattens a dict by SORTED key at every level, so the CNN's leaves come
out as ``conv1/b, conv1/w, conv2/b, ...`` whatever order the dict was built
in, and a tuple in its own order (a transformer's ``params["blocks"]``).
Every function here walks trees in that order, which makes a flat row of
this package equal, element for element, to the reference's
``tree_ravel`` row for the same parameters.  A path holds a dict's key or
a tuple's int index at each level.  Any other node (a list, say) is
refused.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

Path = Tuple[Union[str, int], ...]


def tree_paths(tree, prefix: Path = ()) -> List[Path]:
    """Key path of every leaf, in JAX's leaf order (sorted keys, tuples in
    order)."""
    if isinstance(tree, Mapping):
        out: List[Path] = []
        for k in sorted(tree):
            out += tree_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, tuple):
        out = []
        for i, v in enumerate(tree):
            out += tree_paths(v, prefix + (i,))
        return out
    if not isinstance(tree, torch.Tensor):
        raise TypeError(
            f"parameter trees are nested dicts and tuples of tensors; got {type(tree).__name__} "
            f"at {'/'.join(map(str, prefix)) or '<root>'}"
        )
    return [prefix]


def _get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    return [_get(tree, p) for p in tree_paths(tree)]


def _as_tuples(node):
    """A node built by ``tree_unflatten`` with its int-keyed dicts (the
    tuples) turned back into tuples."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return tuple(_as_tuples(node[i]) for i in range(len(node)))
    return {k: _as_tuples(v) for k, v in node.items()}


def tree_unflatten(paths: Tuple[Path, ...], leaves) -> dict:
    """Rebuild the nested tree whose leaves sit at ``paths``: a level keyed
    by int indices becomes a tuple."""
    out: dict = {}
    seq = False
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
        seq = seq or any(isinstance(k, int) for k in path)
    return _as_tuples(out) if seq else out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees of one structure; a bare tensor
    is a tree of one leaf."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_add(a, b):
    """Elementwise a + b over two trees of one structure."""
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    """Elementwise a - b over two trees of one structure."""
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    """Every leaf of ``a`` times the scalar ``s``."""
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    """A tree of zeros shaped, typed and placed like ``a``'s leaves."""
    return tree_map(torch.zeros_like, a)


def tree_weighted_mean(trees: Sequence, weights):
    """FedAvg of a list of trees (paper eq. 6 and 8): sum_i w_i tree_i / sum_i w_i.

    The weights go to float32 and are normalized by their sum there, with
    no clamp (the kernels clamp at 1e-30); each leaf is stacked in float32,
    contracted with them and cast back to its own dtype.  Plain PyTorch on
    any device: the reference computes it with a ``jnp`` contraction, not a
    Pallas kernel.
    """
    device = tree_leaves(trees[0])[0].device
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device)
    w = w / w.sum()

    def avg(*leaves):
        stacked = torch.stack([l.to(torch.float32) for l in leaves], dim=0)
        return torch.tensordot(w, stacked, dims=1).to(leaves[0].dtype)

    return tree_map(avg, *trees)


def tree_l2_norm(a) -> torch.Tensor:
    """Global L2 norm over every leaf in float32, the squares summed leaf by
    leaf in the sorted-key order (divergence tracking, eq. 17)."""
    total = 0
    for leaf in tree_leaves(a):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def tree_size_bytes(tree) -> int:
    """Total bytes of a tree — the per-round model update payload |W_i|."""
    return int(sum(l.numel() * l.element_size() for l in tree_leaves(tree)))


def tree_num_params(tree) -> int:
    return int(sum(l.numel() for l in tree_leaves(tree)))


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Static layout of a tree, for ravel/unravel round-trips."""

    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(torch.Size(s).numel()) for s in self.shapes)

    @property
    def total_size(self) -> int:
        return sum(self.sizes)


def tree_spec(tree) -> TreeSpec:
    paths = tuple(tree_paths(tree))
    leaves = [_get(tree, p) for p in paths]
    return TreeSpec(
        paths, tuple(tuple(l.shape) for l in leaves), tuple(l.dtype for l in leaves)
    )


def tree_ravel(tree) -> Tuple[torch.Tensor, TreeSpec]:
    """Flatten a tree into one (D,) vector + the spec that inverts it."""
    spec = tree_spec(tree)
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32), spec
    return torch.cat([l.reshape(-1) for l in leaves]), spec


def tree_unravel(spec: TreeSpec, flat: torch.Tensor) -> dict:
    """Inverse of :func:`tree_ravel`."""
    if tuple(flat.shape) != (spec.total_size,):
        raise ValueError(
            f"flat vector has shape {tuple(flat.shape)}, spec wants ({spec.total_size},)"
        )
    # views of ``flat`` by one ``split``, whose gradient is one concatenation
    pieces = torch.split(flat, list(spec.sizes))
    leaves = [t.reshape(shape).to(dtype) for t, shape, dtype in zip(pieces, spec.shapes, spec.dtypes)]
    return tree_unflatten(spec.paths, leaves)
