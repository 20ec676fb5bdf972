"""The production topology's meshes, as ``DeviceMesh``es.

The port of ``src/repro/launch/mesh.py``: the same shapes and axis names.
Importing this module touches no process group.  The caller owns the
group, which must have exactly as many ranks as the mesh: the dry run
creates a ``"fake"`` group of the mesh's size in its own process
(``launch.dryrun_lib.fake_group``), a real run its own group.

``make_hfl_mesh`` factors the data axis into (edge, eu) for the paper's
hierarchical-FL-on-mesh mapping: edge aggregation reduces over ``eu``
only; cloud aggregation reduces over (``pod``, ``edge``).
"""
from __future__ import annotations

from repro_torch.device import resolve_device


def _mesh(shape, names, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {_size(shape)} ranks: create it first")
    if dist.get_world_size() != _size(shape):
        raise ValueError(f"a {shape} mesh needs {_size(shape)} ranks, the group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_hfl_mesh(*, multi_pod: bool = False, n_edges: int = 4, device="cuda"):
    """(pod,) edge x eu x model factorization of the production mesh."""
    if 16 % n_edges:
        raise ValueError(f"n_edges must divide 16, got {n_edges}")
    if multi_pod:
        return _mesh((2, n_edges, 16 // n_edges, 16), ("pod", "edge", "eu", "model"), device)
    return _mesh((n_edges, 16 // n_edges, 16), ("edge", "eu", "model"), device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, multi_pod: bool = False, device="cuda"):
    """A small mesh (a group of n_data * n_model ranks, twice that with
    ``multi_pod``)."""
    if multi_pod:
        return _mesh((2, n_data, n_model), ("pod", "data", "model"), device)
    return _mesh((n_data, n_model), ("data", "model"), device)
