"""The edge mesh and hierarchical FL across processes.

==================  =======================================================
module              role
==================  =======================================================
``axes``            ``EDGE_AXIS``, ``edge_mesh`` (a 1-D ``DeviceMesh``
                    over the ranks of the default process group; one rank
                    without a group), ``run_ranks`` (k local ranks for the
                    tests and the card check)
``hfl_mesh``        per-edge model replicas as a training strategy:
                    ``make_hfl_train_step`` (local and cloud-sync steps)
==================  =======================================================

``engine.mesh_sim.MeshSyncEngine`` runs the federation over an edge mesh.
The reference's sharding hints, ``sharding.py``, ``analysis.py`` and the
PartitionSpec builders are queued (ROADMAP.md Queue 1 item 13).
"""
from repro_torch.distributed.axes import EDGE_AXIS, edge_mesh, mesh_rank, mesh_size, run_ranks
from repro_torch.distributed.hfl_mesh import init_hfl_state, make_hfl_train_step, replicate_for_edges

__all__ = [
    "EDGE_AXIS",
    "edge_mesh",
    "init_hfl_state",
    "make_hfl_train_step",
    "mesh_rank",
    "mesh_size",
    "replicate_for_edges",
    "run_ranks",
]
