"""The edge mesh, hierarchical FL across processes, and the sharding rules.

==================  =======================================================
module              role
==================  =======================================================
``axes``            ``EDGE_AXIS``, ``edge_mesh`` (a 1-D ``DeviceMesh``
                    over the ranks of the default process group; one rank
                    without a group), ``run_ranks`` (k local ranks for the
                    tests and the card check); the activation-sharding
                    hints (``sharding_hints``, ``constrain``,
                    ``grad_cast``) and ``on_shards``
``sharding``        PartitionSpec trees for parameters, batches, caches and
                    optimizer states (modes ``tp`` and ``fsdp``), and
                    ``to_placements``, a spec as DTensor placements
``analysis``        parameter counts, model FLOPs per token, the H100
                    ``Roofline`` and the collective byte counter
``hfl_mesh``        per-edge model replicas as a training strategy:
                    ``make_hfl_train_step`` (local and cloud-sync steps),
                    ``hfl_param_specs``, ``hfl_batch_spec``
==================  =======================================================

``engine.mesh_sim.MeshSyncEngine`` runs the federation over an edge mesh.
The model code imports ``axes`` (its hints), so ``hfl_mesh``, which
imports the training step, is loaded on first use of its names.
"""
from repro_torch.distributed.axes import (
    EDGE_AXIS,
    ShardingHints,
    constrain,
    current_hints,
    edge_mesh,
    grad_cast,
    mesh_rank,
    mesh_size,
    run_ranks,
    sharding_hints,
)

_HFL = ("hfl_batch_spec", "hfl_param_specs", "init_hfl_state", "make_hfl_train_step", "replicate_for_edges")


def __getattr__(name):
    if name in _HFL:
        from repro_torch.distributed import hfl_mesh

        return getattr(hfl_mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "EDGE_AXIS",
    "ShardingHints",
    "constrain",
    "current_hints",
    "edge_mesh",
    "grad_cast",
    "hfl_batch_spec",
    "hfl_param_specs",
    "init_hfl_state",
    "make_hfl_train_step",
    "mesh_rank",
    "mesh_size",
    "replicate_for_edges",
    "run_ranks",
    "sharding_hints",
]
