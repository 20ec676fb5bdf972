"""The hierarchical-FL edge axis (a 1-D ``DeviceMesh`` over process
ranks) and the activation-sharding hints.

The reference lays the federation's edges over a 1-D JAX device mesh and
runs one controller over it.  The port is an SPMD program instead: ``k``
processes ("edge ranks") run the same engine loop, and a
``torch.distributed`` process group stands where the reference has its
``"edge"`` device axis.  Edge ``j`` lives on rank ``j // (E / k)`` with its
EUs' rows; the only cross-rank traffic is the cloud reduction
(``engine.mesh_sim.MeshSyncEngine``).

:func:`edge_mesh` builds the mesh over the default process group's ranks.
With no group, it creates a one-rank group itself (NCCL for a CUDA
engine, gloo for a CPU one, over an in-process ``HashStore``: no port is
opened) and keeps it for the process, so a second call reuses it; a group
the caller created is never torn down.
:func:`run_ranks` spawns ``k`` local ranks for the tests and the card
check: the port's counterpart of the reference's
``--xla_force_host_platform_device_count``.  Rank ``r`` runs on
``cuda:(r % device_count)``, so on one card every rank shares ``cuda:0``;
NCCL refuses two ranks on one device, so ``k > 1`` on one card is gloo,
which reduces CUDA tensors with ``all_reduce`` and ``broadcast`` (the only
collectives the port issues).

The hints (the port of the reference's ``axes.py:22-38, 70-176``): the
sharded train step and the dry run run the model under
``sharding_hints(mesh)``; the model calls ``constrain(x, kind)`` where an
activation must take a layout.  With no hints (every one-card program) it
is the identity; under hints it redistributes a DTensor (a plain tensor
passes through).  ``grad_cast`` is the identity forward and casts the
cotangent, as the reference's.  :func:`on_shards` runs a function on the
local shards of DTensors, the port's way through code that DTensor's
sharding propagation does not cover (the attention core, the MoE experts,
the recurrent mixers, the vocab-parallel embedding and logits).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

EDGE_AXIS = "edge"


def _one_rank_group(device: torch.device) -> None:
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def edge_mesh(n_devices: Optional[int] = None, *, devices: Optional[Sequence[int]] = None, device="cuda"):
    """1-D ``DeviceMesh`` named ``("edge",)`` over the first ``n_devices``
    ranks of ``devices`` (default: every rank of the default process
    group).  ``ValueError`` unless 1 <= n_devices <= the ranks there are.
    ``device`` ("cuda" by default, raising without CUDA unless "cpu") is
    the mesh's device type and picks the backend of a one-rank group this
    call creates."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(world))
    k = len(ranks) if n_devices is None else int(n_devices)
    if k < 1 or k > len(ranks):
        raise ValueError(f"edge_mesh needs 1 <= n_devices <= {len(ranks)} ranks, got {k}")
    if not dist.is_initialized():
        _one_rank_group(dev)
    return DeviceMesh(dev.type, ranks[:k], mesh_dim_names=(EDGE_AXIS,))


def mesh_size(mesh) -> int:
    """Ranks along the mesh's ``"edge"`` axis."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(EDGE_AXIS)))


def mesh_rank(mesh) -> int:
    """This process's coordinate on the ``"edge"`` axis (``ValueError`` on
    a rank outside the mesh)."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the edge mesh {mesh}")
    return int(mesh.get_local_rank(EDGE_AXIS))


def _rank_main(rank, fn, args, n_ranks, backend, store_path, out_dir, threads):
    if threads is not None:
        torch.set_num_threads(threads)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store_path, n_ranks), rank=rank, world_size=n_ranks)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, args=(), *, backend: str = "gloo", timeout: float = 600.0, threads=None):
    """``fn(*args)`` on ``n_ranks`` local processes joined in one process
    group (``backend``, a ``FileStore`` in a temporary directory), each
    rank's result in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    host objects (tensors on the CPU, numpy arrays, numbers).  A rank that
    raises fails the call with its traceback, and every rank is stopped
    when ``timeout`` seconds pass (``TimeoutError``).  ``threads`` sets
    each rank's intra-op thread count."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), n_ranks, backend, os.path.join(tmp, "store"), tmp, threads),
            nprocs=n_ranks, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n_ranks} ranks of {fn.__name__} did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                    if p.is_alive():
                        p.kill()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n_ranks)]


# -- activation-sharding hints ---------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardingHints:
    batch_axes: Optional[Tuple[str, ...]] = None  # ('pod', 'data') / ('data',)
    model_axis: Optional[str] = None  # 'model'
    batch_size: int = 1  # product of the batch axes' sizes
    model_size: int = 1

    @property
    def batch(self):
        if not self.batch_axes:
            return None
        return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]


_HINTS = ShardingHints()


def current_hints() -> ShardingHints:
    return _HINTS


@contextlib.contextmanager
def sharding_hints(mesh=None, *, batch_axes=None, model_axis="model"):
    """Hints derived from ``mesh`` (a ``DeviceMesh``, or any mesh with
    ``axis_names`` and ``shape[name]``): the batch axes are every axis but
    the model axis."""
    from repro_torch.distributed.sharding import mesh_axes

    global _HINTS
    prev = _HINTS
    if mesh is not None:
        axes = mesh_axes(mesh)
        if batch_axes is None:
            batch_axes = tuple(a for a in axes if a != model_axis)
        bs = 1
        for a in batch_axes:
            bs *= axes[a]
        ms = axes.get(model_axis, 1)
    else:
        bs = ms = 1
    _HINTS = ShardingHints(
        tuple(batch_axes) if batch_axes else None,
        model_axis if mesh is not None else None,
        bs,
        ms,
    )
    try:
        yield _HINTS
    finally:
        _HINTS = prev


class _GradCast(torch.autograd.Function):
    """Identity forward; the cotangent cast to ``dtype`` backward (the
    reference's ``custom_vjp`` gate)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def grad_cast(x, dtype=None):
    """Identity in the forward; casts the COTANGENT to ``dtype`` (default
    x's dtype) in the backward, so that a collective on it moves that
    dtype and not the fp32 of an fp32-accumulated product.  As the
    reference's, it casts with or without hints (autograd then hands a
    leaf its gradient in the leaf's own dtype); the port's models call it
    nowhere."""
    return _GradCast.apply(x, dtype or x.dtype)


def kind_spec(shape, kind: str):
    """The reference's canonical PartitionSpec for an activation of
    ``shape`` and ``kind`` under the current hints (None: no layout):

      tokens : (B, S, d)        -> P(batch, model, None)   [sequence parallel]
      heads  : (B, S, H, Dh)    -> P(batch, None, model, None)
      probs  : (B, H, q, k)     -> P(batch, model, None, None)
      inner  : (B, S, d_inner)  -> P(batch, None, model)
      ssm    : (B, S, di, n)    -> P(batch, None, model, None)
      rwkv5  : (B, H, C, C, hs) -> P(batch, model, None, None, None)
      kvlogits: (B, H, q, S)    -> P(batch, None, None, model)
      dispatch: (g, tg, E, C)   -> P(batch, None, model, None)
      experts : (g, E, C, d)    -> P(batch, model, None, None)
      state  : (B, H|d_inner, ...) -> P(batch, model, ...)

    and one of the port's own:

      batch  : (B, ...)         -> P(batch, None, ...)  [the residual stream]

    The batch dim is constrained only where it divides the batch axes, a
    model dim only where it divides the model axis."""
    from repro_torch.distributed.sharding import P

    h = _HINTS
    if h.batch_axes is None and h.model_axis is None:
        return None
    m, nd = h.model_axis, len(shape)
    b = h.batch if (h.batch and shape[0] % h.batch_size == 0 and shape[0] >= h.batch_size) else None

    def mod(dim):
        return m if (m and shape[dim] % h.model_size == 0 and shape[dim] >= h.model_size) else None

    table = {
        ("tokens", 3): lambda: P(b, mod(1), None),
        ("heads", 4): lambda: P(b, None, mod(2), None),
        ("probs", 4): lambda: P(b, mod(1), None, None),
        ("inner", 3): lambda: P(b, None, mod(2)),
        ("ssm", 4): lambda: P(b, None, mod(2), None),
        ("rwkv5", 5): lambda: P(b, mod(1), None, None, None),
        ("kvlogits", 4): lambda: P(b, None, None, mod(3)),
        ("dispatch", 4): lambda: P(b, None, mod(2), None),
        ("experts", 4): lambda: P(b, mod(1), None, None),
    }
    if (kind, nd) in table:
        return table[(kind, nd)]()
    if kind == "state" and nd >= 2:
        return P(b, mod(1), *([None] * (nd - 2)))
    if kind == "batch" and nd >= 1:
        return P(b, *([None] * (nd - 1)))
    return None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements`` in the forward, and the cotangent to
    the same placements in the backward, as ``with_sharding_constraint``
    constrains both."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == tuple(placements):
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def constrain(x, kind: str):
    """Lay activation ``x`` out as ``kind`` (:func:`kind_spec`), and its
    cotangent too.  The identity with no hints, for a plain tensor, and
    for a kind the rank of ``x`` does not match; under hints a DTensor is
    redistributed to the kind's placements."""
    if not is_dtensor(x):
        return x
    spec = kind_spec(tuple(x.shape), kind)
    if spec is None:
        return x
    from repro_torch.distributed.sharding import to_placements

    return _Constrain.apply(x, tuple(to_placements(spec, x.device_mesh)))


def spec_of(x):
    """The PartitionSpec of DTensor ``x``'s placements (the inverse of
    ``to_placements``: each dim's mesh axes in mesh order)."""
    from repro_torch.distributed.sharding import P

    names = list(x.device_mesh.mesh_dim_names)
    entries = [[] for _ in range(x.dim())]
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            entries[pl.dim % x.dim()].append(names[i])
    return P(*[None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries])


def shard_offset(x, dim: int) -> int:
    """Where this rank's shard of DTensor ``x`` starts along ``dim``: the
    split over its mesh dims in mesh order, each a ``torch.chunk`` of what
    the one before left (pure arithmetic on the rank's coordinate, so it
    runs under fake tensors)."""
    coord = x.device_mesh.get_coordinate()
    size, offset = x.shape[dim], 0
    for i, pl in enumerate(x.placements):
        if pl.is_shard() and pl.dim % x.dim() == dim:
            chunk = -(-size // x.device_mesh.size(i))
            offset += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return offset


def redistribute_to(x, spec):
    """DTensor ``x`` laid out as PartitionSpec ``spec`` on its mesh, and
    its cotangent too (no collective where they already are)."""
    from repro_torch.distributed.sharding import to_placements

    return _Constrain.apply(x, tuple(to_placements(spec, x.device_mesh)))


def _redistribute(x, spec):
    from repro_torch.distributed.sharding import to_placements

    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose gradient is laid out as ``grad`` (a
    Partial output's gradient is the replicated whole on every rank)."""

    @staticmethod
    def forward(ctx, local, mesh, placements, grad, shape, stride):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.grad = mesh, grad
        return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.grad):
            g = g.redistribute(ctx.mesh, ctx.grad)
        return g.to_local(), None, None, None, None, None


@dataclasses.dataclass(frozen=True)
class Whole:
    """An :func:`on_shards` input laid out as ``spec`` whose gradient comes
    back as a partial sum over the mesh axes ``over`` (default: the batch
    axes): a weight every batch shard uses whole, or an activation each
    model rank uses for its own part of a sum."""

    spec: tuple
    over: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class Summed:
    """An :func:`on_shards` output laid out as ``spec`` that is a partial
    sum over the mesh axes ``over`` (default: the model axis), e.g. over
    each rank's experts or its slice of a contracted dim."""

    spec: tuple
    over: Optional[Tuple[str, ...]] = None


def _partial_over(placements, names, over):
    from torch.distributed.tensor import Partial

    placements = list(placements)
    for ax in over:
        if ax in names:
            placements[names.index(ax)] = Partial("sum")
    return tuple(placements)


def on_shards(fn, args, in_specs, out_specs):
    """``fn`` on the local shards of DTensor ``args``: the port's way
    through code that DTensor's sharding propagation does not cover.

    Each ``args[i]`` is first redistributed to ``in_specs[i]`` (a
    PartitionSpec, or :class:`Whole`), ``fn`` runs on the local tensors,
    and each output is wrapped as a DTensor laid out as ``out_specs[i]``
    (a PartitionSpec, or :class:`Summed`; ``out_specs`` may be a function
    of the tuple of local outputs).  With no DTensor among
    ``args`` it is ``fn(*args)``: one-card programs never come here."""
    from repro_torch.distributed.sharding import to_placements

    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    names = list(mesh.mesh_dim_names)
    h = _HINTS
    locs = []
    for a, spec in zip(args, in_specs):
        if isinstance(spec, Whole):
            a = _redistribute(a, spec.spec)
            over = h.batch_axes or () if spec.over is None else spec.over
            locs.append(a.to_local(grad_placements=_partial_over(a.placements, names, over)))
        else:
            locs.append(_redistribute(a, spec).to_local())
    outs = fn(*locs)
    single = not isinstance(outs, tuple)
    if callable(out_specs):  # specs from the local outputs
        out_specs = out_specs((outs,) if single else outs)
    wrapped = []
    for o, spec in zip((outs,) if single else outs, out_specs):
        o = o.contiguous()  # the DTensor's stride is the contiguous one
        summed = isinstance(spec, Summed)
        base = spec.spec if summed else spec
        grad = tuple(to_placements(base, mesh))
        placements = grad
        if summed:
            placements = _partial_over(grad, names, (h.model_axis,) if spec.over is None else spec.over)
        shape, stride = _global_meta(o, base, mesh)
        wrapped.append(_FromLocal.apply(o, mesh, placements, grad, shape, stride))
    return wrapped[0] if single else tuple(wrapped)


def on_batch_shards(fn, params, *acts):
    """``fn(params, *acts)`` data-parallel: every rank runs it on its rows
    of the batch-leading activations ``acts`` with ``params`` (a tree)
    gathered whole, and its outputs (a tuple of batch-leading tensors) are
    laid out over the batch axes.  The model axis' ranks repeat the work:
    the layout of a block whose internals DTensor does not cover and that
    has no model-parallel form here (the Mamba and RWKV mixers)."""
    from repro_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten

    paths = tree_paths(params)
    leaves = tree_leaves(params)
    n = len(leaves)
    rows = [kind_spec(tuple(a.shape), "batch") for a in acts]

    def local(*flat):
        return fn(tree_unflatten(paths, flat[:n]), *flat[n:])

    def replicated(t):
        from repro_torch.distributed.sharding import P

        return Whole(P(*([None] * t.dim())))

    if not any(is_dtensor(a) for a in list(acts) + leaves):
        return fn(params, *acts)
    batch = rows[0][0]

    def out_specs(outs):
        from repro_torch.distributed.sharding import P

        return tuple(P(batch, *([None] * (o.dim() - 1))) for o in outs)

    return on_shards(local, tuple(leaves) + tuple(acts), tuple(replicated(l) for l in leaves) + tuple(rows),
                     out_specs)


def _global_meta(local, spec, mesh):
    """The global shape and contiguous stride of a tensor whose even
    shards ``local`` are laid out as ``spec``."""
    from repro_torch.distributed.sharding import mesh_axes

    axes = mesh_axes(mesh)
    shape = list(local.shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            shape[d] *= axes[name]
    stride, acc = [0] * len(shape), 1
    for d in range(len(shape) - 1, -1, -1):
        stride[d] = acc
        acc *= max(shape[d], 1)
    return torch.Size(shape), tuple(stride)
