"""The hierarchical-FL edge axis: a 1-D ``DeviceMesh`` over process ranks.

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
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Optional, Sequence

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
