"""Parameter trees: nested dicts of tensors, flattened in JAX's leaf order.

JAX flattens a dict by SORTED key at every level, so the CNN's leaves come
out as ``conv1/b, conv1/w, conv2/b, ...`` whatever order the dict was built
in.  Every function here walks trees in that order, which makes a flat row
of this package equal, element for element, to the reference's
``tree_ravel`` row for the same parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Tuple

import torch

Path = Tuple[str, ...]


def tree_paths(tree, prefix: Path = ()) -> List[Path]:
    """Key path of every leaf, in JAX's leaf order (sorted keys)."""
    if isinstance(tree, Mapping):
        out: List[Path] = []
        for k in sorted(tree):
            out += tree_paths(tree[k], prefix + (k,))
        return out
    if not isinstance(tree, torch.Tensor):
        raise TypeError(
            f"parameter trees are nested dicts of tensors; got {type(tree).__name__} "
            f"at {'/'.join(prefix) or '<root>'}"
        )
    return [prefix]


def _get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    return [_get(tree, p) for p in tree_paths(tree)]


def tree_unflatten(paths: Tuple[Path, ...], leaves) -> dict:
    """Rebuild the nested dict whose leaves sit at ``paths``."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees of one structure; a bare tensor
    is a tree of one leaf."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


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
    leaves = []
    off = 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        leaves.append(flat[off : off + size].reshape(shape).to(dtype))
        off += size
    return tree_unflatten(spec.paths, leaves)
