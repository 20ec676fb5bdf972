"""End-to-end experiment scenario builder: dataset -> EUs -> assignment -> sim.

The paper's two setups, with the paper's 1-D CNN:
  * Heartbeat: 5 classes, 5 edges, 18 EUs (Table 3 edge distribution)
  * Seizure:   3 classes, 3 edges, 13 EUs (Table 2 edge distribution)

The data come from the same numpy stream as the reference's, so the shards,
test set and class counts are byte-equal to its ``build_scenario`` at the
same seed and scale.  The topology and the initial parameters come from a
``torch.Generator`` seeded from ``seed`` (the reference draws both from
``jax.random``, which cannot be repeated here); that generator never
touches the data stream.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.assignment import AssignmentResult, dba_assignment, eara, random_assignment
from repro_torch.core.hfl import HFLSchedule
from repro_torch.data.partition import (
    TABLE2_SEIZURE,
    TABLE3_HEARTBEAT,
    eu_counts_from_edge_table,
    split_dataset_by_counts,
)
from repro_torch.data.synthetic_health import Dataset, heartbeat_like, seizure_like
from repro_torch.device import resolve_device
from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import ClientProgram, CNNProgram
from repro_torch.federated.simulation import SimResult
from repro_torch.models.cnn1d import HEARTBEAT_CNN, SEIZURE_CNN
from repro_torch.utils.tree import tree_size_bytes
from repro_torch.wireless.channel import WirelessParams, build_cost_matrices, sample_topology

# where each reference option not carried by this port is queued (ROADMAP.md)
_QUEUED = {
    "engine='reference'": "Queue 1, readable simulator",
    "engine='async'": "Queue 1, async engine",
    "pipeline='host'": "Queue 1, host pipeline",
    "pipeline='mesh'": "Queue 1, mesh",
    "mesh": "Queue 1, mesh",
    "compression": "Queue 1, compression",
    "faults": "Queue 1, faults",
    "telemetry": "Queue 1, telemetry",
    "cohort": "Queue 1, streaming populations",
    "server_momentum": "Queue 1, streaming populations",
    "lazy": "Queue 1, streaming populations",
    "serve": "Queue 1, serving",
    "distill": "Queue 1, heterogeneous models",
    "model_mix": "Queue 1, heterogeneous models",
    "track_divergence": "Queue 1, readable simulator",
    "fedsgd": "Queue 1, programs",
    "model": "Queue 1, programs (mlp) and sequence models",
}


def _not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to repro_torch yet; it is queued in ROADMAP.md "
        f"({_QUEUED[option]})"
    )


@dataclasses.dataclass
class Scenario:
    name: str
    program: ClientProgram
    clients: List[FLClient]
    test: Dataset
    class_counts: np.ndarray  # (M, K)
    topo: object
    cost: object
    wp: WirelessParams
    model_bits: float
    init_edge: np.ndarray

    @property
    def n_edges(self) -> int:
        return self.cost.latency.shape[1]

    def assign(self, strategy: str, *, device="cuda", **kw) -> AssignmentResult:
        """``"eara-sca"`` | ``"eara-dca"`` (``+`` adds local search) |
        ``"dba"`` | ``"random"``; the EARA LP runs on ``device``."""
        resolve_device(device)
        if strategy == "dba":
            return dba_assignment(self.class_counts, self.topo.dist)
        if strategy == "random":
            return random_assignment(self.class_counts, self.n_edges, **kw)
        if strategy in ("eara-sca", "eara-dca", "eara-sca+", "eara-dca+"):
            return eara(
                self.class_counts,
                self.cost,
                self.wp,
                self.model_bits,
                self.topo.tx_power_max,
                mode="sca" if "sca" in strategy else "dca",
                refine=strategy.endswith("+"),
                device=device,
                **kw,
            )
        raise ValueError(strategy)

    def simulate(
        self,
        assignment: np.ndarray,
        cloud_rounds: int,
        schedule: HFLSchedule = HFLSchedule(1, 1),
        seed: int = 0,
        upp: float = 1.0,
        track_divergence: bool = False,
        eval_every: int = 1,
        wall_clock: bool = False,
        engine: str = "sync",
        backend: str = "kernel",
        compression=None,
        pipeline: str = "device",
        distill=None,
        faults=None,
        telemetry=None,
        cohort=None,
        server_momentum: float = 0.0,
        mesh=None,
        serve=None,
        device="cuda",
    ) -> SimResult:
        """Run the scenario through the batched synchronous engine.

        engine:   "sync" (the only engine ported so far, hence the default;
                  the reference's "reference" and "async" raise).
        pipeline: "device" (the reference's "host" and "mesh" raise).
        backend:  aggregation path, "kernel" (the CUDA kernels on the card,
                  their plain versions on the CPU) | "reference".
        device:   where the engine runs; "cuda" by default, raising without
                  CUDA unless "cpu" is asked for.

        Every other option of the reference's ``simulate`` raises
        ``NotImplementedError`` when set, naming the queued slice.
        """
        if engine not in ("reference", "sync", "async"):
            raise ValueError(f"unknown engine {engine!r} (reference | sync | async)")
        if pipeline not in ("device", "host", "mesh"):
            raise ValueError(f"unknown pipeline {pipeline!r} (device | host | mesh)")
        if engine != "sync":
            raise _not_ported(f"engine={engine!r}")
        if pipeline != "device":
            raise _not_ported(f"pipeline={pipeline!r}")
        if mesh is not None:
            raise _not_ported("mesh")
        for option, value in (
            ("compression", compression),
            ("distill", distill),
            ("faults", faults),
            ("telemetry", telemetry),
            ("cohort", cohort),
            ("serve", serve),
            ("track_divergence", track_divergence),
            ("server_momentum", server_momentum),
        ):
            if value is not None and value is not False and value != 0.0:
                raise _not_ported(option)
        from repro_torch.engine.sync_sim import BatchedSyncEngine

        sim = BatchedSyncEngine(
            self.clients,
            assignment,
            self.program,
            self.test,
            schedule=schedule,
            seed=seed,
            upp=upp,
            cost_latency=self.cost.latency if wall_clock else None,
            backend=backend,
            pipeline=pipeline,
            device=device,
        )
        return sim.run(cloud_rounds, eval_every=eval_every)


def _eus_per_edge(n_edges: int, n_eus: int) -> List[int]:
    base = n_eus // n_edges
    extra = n_eus - base * n_edges
    return [base + (1 if j < extra else 0) for j in range(n_edges)]


def _hparam_kwargs(hparams: Optional[Sequence[Optional[Mapping]]], n_eus: int) -> List[dict]:
    """Validate per-EU hyperparameter overrides into FLClient kwargs."""
    if hparams is None:
        return [{}] * n_eus
    if len(hparams) != n_eus:
        raise ValueError(f"hparams must have one entry per EU ({n_eus}), got {len(hparams)}")
    allowed = {"lr", "batch_size", "local_epochs", "max_steps"}
    out = []
    for hp in hparams:
        hp = dict(hp or {})
        unknown = set(hp) - allowed
        if unknown:
            raise ValueError(f"unknown hyperparameters {sorted(unknown)}; allowed: {sorted(allowed)}")
        out.append(hp)
    return out


def build_scenario(
    dataset: str = "heartbeat",
    *,
    model: str = "cnn",
    model_mix: Optional[Mapping[str, int]] = None,
    fedsgd: bool = False,
    hparams: Optional[Sequence[Optional[Mapping]]] = None,
    faults=None,
    seed: int = 0,
    scale: float = 1.0,
    mean_dist: float = 300.0,
    n_test_per_class: int = 300,
    wp: Optional[WirelessParams] = None,
    lazy: bool = False,
    device="cuda",
) -> Scenario:
    """The paper's heartbeat or seizure setup with the 1-D CNN.

    ``hparams`` (optional) is one mapping per EU of ``FLClient`` overrides
    (``lr`` | ``batch_size`` | ``local_epochs`` | ``max_steps``).  The cost
    matrices are evaluated on ``device`` ("cuda" by default; raises without
    CUDA unless "cpu").  The reference's other workloads (``model`` other
    than "cnn", ``fedsgd``, ``model_mix``, ``lazy``, ``faults``, the "lm"
    dataset) raise ``NotImplementedError``.
    """
    resolve_device(device)
    if lazy:
        raise _not_ported("lazy")
    if model_mix is not None:
        raise _not_ported("model_mix")
    if fedsgd:
        raise _not_ported("fedsgd")
    if faults is not None:
        raise _not_ported("faults")
    if model != "cnn":
        raise _not_ported("model")
    rng = np.random.default_rng(seed)
    if dataset == "heartbeat":
        table, n_eus, cnn, maker = TABLE3_HEARTBEAT, 18, HEARTBEAT_CNN, heartbeat_like
    elif dataset == "seizure":
        table, n_eus, cnn, maker = TABLE2_SEIZURE, 13, SEIZURE_CNN, seizure_like
    elif dataset == "lm":
        raise _not_ported("model")
    else:
        raise ValueError(dataset)
    n_edges, k = table.shape
    counts, init_edge = eu_counts_from_edge_table(
        rng, table, _eus_per_edge(n_edges, n_eus), scale=scale
    )
    train = maker(rng, counts.sum(axis=0))
    shards = split_dataset_by_counts(rng, train, counts)
    test = maker(rng, np.full(k, n_test_per_class))
    program = CNNProgram(cnn)
    kw = _hparam_kwargs(hparams, n_eus)
    clients = [FLClient(i, shards[i], program, **kw[i]) for i in range(n_eus)]
    wp = wp or WirelessParams()
    gen = torch.Generator().manual_seed(seed)
    topo = sample_topology(
        gen, n_eus, n_edges, mean_dist=mean_dist, dataset_sizes=counts.sum(axis=1)
    )
    model_bits = tree_size_bytes(program.init(gen)) * 8
    cost = build_cost_matrices(topo, model_bits, wp, device=device)
    return Scenario(
        name=dataset,
        program=program,
        clients=clients,
        test=test,
        class_counts=counts,
        topo=topo,
        cost=cost,
        wp=wp,
        model_bits=model_bits,
        init_edge=init_edge,
    )
