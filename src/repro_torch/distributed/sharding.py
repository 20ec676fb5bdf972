"""Sharding rules: every parameter, batch and cache leaf mapped to a
``PartitionSpec``, and a spec turned into DTensor placements.

The port of ``src/repro/distributed/sharding.py``, in plain Python over the
leaves' shapes (meta tensors will do).  Two modes:

  * ``tp``   -- tensor parallel only: weights sharded over the ``model``
               axis (Megatron column/row rules), replicated over data/pod;
  * ``fsdp`` -- tp plus the complementary weight dim sharded over ``data``
               (and ``pod``), ZeRO-3 style.

The rules go by path name (wq/wk/wv/wi/wg -> column parallel; wo/out_proj/
x_proj -> row parallel; emb -> vocab parallel; experts -> expert parallel
when divisible).  Stacked-block leading axes are never sharded.

A spec is the reference's data: one entry per leaf dimension, each ``None``,
one mesh axis name, or a tuple of names (a dimension sharded over several
axes, major to minor).  :class:`PartitionSpec` is a tuple, so a spec tree
compares equal to the reference's entry for entry.  A mesh is anything
with ``axis_names`` and ``shape[name]`` (a duck-typed test mesh) or a
``DeviceMesh`` (its ``mesh_dim_names`` and ``size(i)``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten

COLUMN_KEYS = ("wq", "wk", "wv", "wi", "wg", "in_proj", "dt_proj", "w_a", "wr")
ROW_KEYS = ("wo", "out_proj", "x_proj", "w_b")


class PartitionSpec(tuple):
    """One entry per leaf dimension: ``None``, an axis name, or a tuple of
    axis names; ``PartitionSpec("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """The mesh's axis sizes by name, in its dimension order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def _data_axes(axes: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axes)


def _joined(axes: Tuple[str, ...]):
    """A spec entry over ``axes``: one name, a tuple of names, or None."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _path_names(path) -> Tuple[str, ...]:
    return tuple(str(n) for n in path)


def _spec_for_leaf(
    names: Tuple[str, ...],
    shape: Tuple[int, ...],
    mode: str,
    *,
    model_axis: str,
    data_axes: Tuple[str, ...],
    model_size: int,
    data_size: int,
) -> PartitionSpec:
    nd = len(shape)
    spec = [None] * nd
    data_sh = _joined(data_axes)

    def divis(dim_idx, size):
        # a mesh without the axis (size None) shards nothing over it
        return size is not None and shape[dim_idx] % size == 0 and shape[dim_idx] >= size

    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""

    # MoE expert stacks: (n_blocks, E, d, f) or (E, d, f)
    if leaf in ("wi", "wg", "wo") and nd >= 3 and "ffn" in names and parent == "ffn":
        e_dim = nd - 3
        if divis(e_dim, model_size):
            spec[e_dim] = model_axis  # expert parallel
            if mode == "fsdp":
                # shard the biggest remaining dim over data
                cand = nd - 1 if shape[nd - 1] >= shape[nd - 2] else nd - 2
                if divis(cand, data_size):
                    spec[cand] = data_sh
            return P(*spec)
        # fine-grained experts that don't divide: shard the ff dim instead
        ff_dim = nd - 1 if leaf in ("wi", "wg") else nd - 2
        if divis(ff_dim, model_size):
            spec[ff_dim] = model_axis
        if mode == "fsdp":
            other = nd - 2 if ff_dim == nd - 1 else nd - 1
            if divis(other, data_size):
                spec[other] = data_sh
        return P(*spec)

    if leaf == "emb":
        # vocab-parallel embedding: (V, d)
        if divis(nd - 2, model_size):
            spec[nd - 2] = model_axis
        if mode == "fsdp" and divis(nd - 1, data_size):
            spec[nd - 1] = data_sh
        return P(*spec)

    col = parent in COLUMN_KEYS or leaf in COLUMN_KEYS
    row = parent in ROW_KEYS or leaf in ROW_KEYS
    if leaf == "w" and len(names) >= 2:
        col = names[-2] in COLUMN_KEYS
        row = names[-2] in ROW_KEYS
    if nd >= 2 and (col or row):
        tgt = nd - 1 if col else nd - 2
        if divis(tgt, model_size):
            spec[tgt] = model_axis
        if mode == "fsdp":
            other = nd - 2 if tgt == nd - 1 else nd - 1
            if divis(other, data_size):
                spec[other] = data_sh
        return P(*spec)

    # conv / a_log / bonus style (..., d_inner) or (heads, hs) leaves
    if nd >= 2 and leaf in ("conv_w", "a_log", "bonus"):
        tgt = nd - 1 if leaf == "conv_w" else nd - 2
        if divis(tgt, model_size):
            spec[tgt] = model_axis
        return P(*spec)

    # biases over sharded output dims
    if leaf == "b" and len(names) >= 2 and names[-2] in COLUMN_KEYS and nd >= 1:
        if divis(nd - 1, model_size):
            spec[nd - 1] = model_axis
        return P(*spec)

    return P(*spec)  # replicated (norms, small vectors)


def map_specs(fn, spec_tree):
    """``fn`` over the PartitionSpecs of a spec tree (dicts and tuples
    of specs; a spec is itself a tuple, so it is told apart by type)."""
    if isinstance(spec_tree, PartitionSpec):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple):
        return tuple(map_specs(fn, v) for v in spec_tree)
    raise TypeError(f"a spec tree holds dicts, tuples and PartitionSpecs; got {type(spec_tree).__name__}")


def _map_with_path(fn, tree):
    paths = tree_paths(tree)
    return tree_unflatten(paths, [fn(p, leaf) for p, leaf in zip(paths, tree_leaves(tree))])


def param_specs(cfg: ModelConfig, params: Any, mode: str, mesh) -> Any:
    """PartitionSpec tree matching ``params`` (meta tensors will do).

    A mesh without a ``model`` axis (the 1-D edge mesh) shards nothing
    over it, and one without ``data`` or ``pod`` nothing over those; the
    reference requires a ``model`` axis."""
    del cfg  # the rules go by path and shape, as the reference's
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"sharding mode must be 'tp' or 'fsdp', got {mode!r}")
    axes = mesh_axes(mesh)
    data_axes = _data_axes(axes)
    model_size = axes.get("model")
    data_size = _prod(axes[a] for a in data_axes) if data_axes else None

    def one(path, leaf):
        return _spec_for_leaf(_path_names(path), tuple(leaf.shape), mode, model_axis="model",
                              data_axes=data_axes, model_size=model_size, data_size=data_size)

    return _map_with_path(one, params)


def batch_spec(shape: InputShape, mesh, *, enc: bool = False) -> PartitionSpec:
    """Token batch (B, S): the batch over (pod, data) when it divides."""
    del enc
    axes = mesh_axes(mesh)
    data_axes = _data_axes(axes)
    bsz = shape.global_batch
    if bsz % _prod(axes[a] for a in data_axes) == 0:
        return P(_joined(data_axes), None)
    if bsz % axes["data"] == 0:
        return P("data", None)
    return P(None, None)


def cache_specs(cfg: ModelConfig, cache: Any, shape: InputShape, mesh) -> Any:
    """KV and recurrent-state caches.

    Attention k/v (n_blocks, B, S, Hkv, Dh): the batch over (pod, data)
    when it divides, else the SEQUENCE axis (context-parallel decode,
    long_500k's batch of 1).  Mamba and RWKV states shard their channel or
    head dims over ``model``."""
    del cfg
    axes = mesh_axes(mesh)
    data_axes = _data_axes(axes)
    d = _prod(axes[a] for a in data_axes)
    m = axes["model"]
    batch_ok = shape.global_batch % d == 0 and shape.global_batch >= d
    data_sh = _joined(data_axes)
    # leaf name and rank -> the dim sharded over ``model`` (batch is dim 1)
    state_dims = {("h", 4): 2, ("conv", 4): 3, ("s", 5): 2, ("x_prev", 3): 2}

    def one(path, leaf):
        name, sh = str(path[-1]), tuple(leaf.shape)
        nd = len(sh)
        spec = [None] * nd
        if name in ("k", "v", "cross_k", "cross_v"):
            if batch_ok:
                spec[1] = data_sh
                if sh[2] % m == 0:
                    spec[2] = "model"  # seq over model: context parallel
            elif sh[2] % (d * m) == 0:
                spec[2] = data_axes + ("model",)
            elif sh[2] % m == 0:
                spec[2] = "model"
            return P(*spec)
        if (name, nd) in state_dims:
            if batch_ok:
                spec[1] = data_sh
            dim = state_dims[(name, nd)]
            if sh[dim] % m == 0:
                spec[dim] = "model"
            return P(*spec)
        if nd >= 2 and batch_ok:  # fallback: the batch dim
            spec[1] = data_sh
        return P(*spec)

    return _map_with_path(one, cache)


def opt_state_specs(param_spec_tree, opt_state, params) -> Any:
    """Adam's (m, v) mirror the parameter specs; ``sgd``'s () stays ();
    any other state is replicated."""
    del params
    if isinstance(opt_state, tuple) and len(opt_state) == 2:
        return (param_spec_tree, param_spec_tree)
    if isinstance(opt_state, tuple) and len(opt_state) == 0:
        return ()
    return _map_with_path(lambda _p, _leaf: P(), opt_state)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_placements(spec, mesh):
    """DTensor placements for ``spec``, one per mesh dimension: ``Shard(d)``
    on each mesh dimension that names leaf dimension ``d``, else
    ``Replicate()``.

    A leaf dimension sharded over several axes (``("pod", "data")``) is
    ``Shard(d)`` on each of them.  DTensor splits such a dimension over its
    mesh dimensions in mesh order, the first the most major, which is the
    reference's major-to-minor order only when the spec names the axes in
    mesh order: any other order raises ``ValueError``, never a silently
    different layout."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    placements = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        names = _entry_axes(entry)
        idx = [order.index(n) if n in order else -1 for n in names]
        if -1 in idx:
            raise ValueError(f"spec {spec!r} names an axis the mesh {order} lacks")
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(
                f"spec {spec!r} shards dim {d} over {names}, not in the mesh's order {order}; "
                "DTensor would lay it out in another order"
            )
        for i in idx:
            if isinstance(placements[i], Shard):
                raise ValueError(f"spec {spec!r} uses mesh axis {order[i]!r} twice")
            placements[i] = Shard(d)
    return placements


def local_shape(shape, spec, mesh, coordinate=None) -> Tuple[int, ...]:
    """The shard of a ``shape`` leaf laid out by ``spec`` that the rank at
    ``coordinate`` (one index per mesh dimension; rank 0's by default)
    holds, by ``torch.chunk``'s arithmetic, as DTensor splits: the first
    shards are the largest."""
    axes = mesh_axes(mesh)
    order = list(axes)
    coord = [0] * len(order) if coordinate is None else list(coordinate)
    out = list(shape)
    for d, entry in enumerate(spec):
        for name in _entry_axes(entry):
            n, i = axes[name], coord[order.index(name)]
            size = -(-out[d] // n)
            out[d] = max(0, min(size, out[d] - i * size))
    return tuple(out)
