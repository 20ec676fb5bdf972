"""End-to-end experiment scenario builder: dataset -> EUs -> assignment -> sim.

The paper's two setups, with the paper's 1-D CNN (or the MLP, or FedSGD
over either):
  * Heartbeat: 5 classes, 5 edges, 18 EUs (Table 3 edge distribution)
  * Seizure:   3 classes, 3 edges, 13 EUs (Table 2 edge distribution)

and the token-stream population of the sequence programs
(``build_scenario("lm")`` or ``model="lm"``): ``lm_eus`` EUs over
``lm_edges`` edges, each shard dominated by one Markov topic, the topics
standing in for classes so that the KLD-aware assignment has an imbalance
to balance.  Every sequence program of the reference trains there: the
dense transformer LM, the MoE LM, the Mamba hybrid and RWKV.

``model_mix=`` builds a heterogeneous-MODEL population instead: a mapping
of program names to EU counts (``{"cnn": 12, "mlp": 6}``, or ``{"lm": 6,
"mamba": 3, "rwkv": 3}`` on the token population) gives each EU its program, one small
PUBLIC shard per edge is drawn after the test set (so the private shards
stay byte-equal to the homogeneous builder's), and the engines fuse the
per-architecture edge models by logit distillation on it
(``engine.distill``).

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
from repro_torch.data.lm_stream import TokenStream
from repro_torch.data.partition import (
    TABLE2_SEIZURE,
    TABLE3_HEARTBEAT,
    eu_counts_from_edge_table,
    split_dataset_by_counts,
)
from repro_torch.data.synthetic_health import Dataset, heartbeat_like, seizure_like
from repro_torch.device import resolve_device
from repro_torch.engine.distill import DistillSpec
from repro_torch.faults import FaultSpec, FaultState
from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import (
    PROGRAMS,
    SEQUENCE_PROGRAMS,
    ClientProgram,
    CNNProgram,
    FedSGDProgram,
    MLPProgram,
)
from repro_torch.federated.simulation import (
    HeteroHFLSimulation,
    HFLSimulation,
    RoundMetrics,
    SimResult,
    centralized_baseline,
)
from repro_torch.federated.stream import build_stream_scenario
from repro_torch.models.cnn1d import HEARTBEAT_CNN, SEIZURE_CNN
from repro_torch.serving.traffic import ServeTraffic, TrafficSpec
from repro_torch.telemetry import coerce_telemetry
from repro_torch.utils.tree import tree_size_bytes
from repro_torch.wireless.channel import WirelessParams, build_cost_matrices, sample_topology

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
    # heterogeneous-model populations (model_mix=): one public Dataset per
    # edge for the distillation fuse and the fuse's default DistillSpec;
    # both None for a homogeneous population
    public: Optional[List[Dataset]] = None
    distill: object = None
    # default fault model (a ``repro_torch.faults.FaultSpec``); None is
    # fault-free.  Each simulate() call builds a fresh FaultState, so runs
    # never share energy balances or dispatch counters
    faults: object = None

    @property
    def is_hetero(self) -> bool:
        """True when the population mixes client programs (architectures)."""
        return len({c.program for c in self.clients}) > 1

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
        engine: str = "reference",
        backend: str = "kernel",
        compression=None,
        staleness_decay: float = 0.5,
        quorum: float = 0.75,
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
        """Run the scenario through one of the simulation engines.

        engine:   "reference" — the readable simulator (``HFLSimulation``;
                  ``HeteroHFLSimulation`` for a ``model_mix`` population);
                  "sync"      — the batched engine, same semantics;
                  "async"     — the event-driven engine
                  (``AsyncHFLEngine``: ``staleness_decay`` in [0, 1],
                  ``quorum`` in (0, 1], the scenario's latency matrix as
                  its clock).
        pipeline: the sync engine's round: "device" (fixed-shape segment
                  kernel programs, shard store) | "host" (per-client jobs,
                  one ``flat_mean`` per edge) | "mesh" (``MeshSyncEngine``:
                  the device pipeline with the edges split over the ranks
                  of an edge mesh; the result carries ``comm_report``).
        mesh:     the mesh engine's edge mesh: a rank count, a
                  ``DeviceMesh`` with an "edge" dimension, or None (the
                  largest rank count of the default process group that
                  divides the edge count).  Given, it selects the mesh
                  engine under ``engine="sync"``; the other engines ignore
                  ``pipeline="mesh"`` and ``mesh``, as in the reference.
        backend:  the engines' aggregation path, "kernel" (the CUDA
                  kernels on the card, their plain versions on the CPU) |
                  "reference"; the readable simulator ignores it.
        compression: None | ``core.compression.CompressionSpec`` ("topk" |
                  "ternary" | "none") on the uplinks, with error feedback;
                  the accountant counts the compressed bits.  It overrides
                  the program's own upload quantization (FedSGD's
                  ``grad_bits=16``).
        faults:   a ``repro_torch.faults.FaultSpec`` (churn, energy budgets,
                  time-varying channels, the async retry policy); None
                  takes the scenario's default (``build_scenario(faults=)``)
                  and False forces the fault-free path.  A fresh
                  ``FaultState`` is built per call.
        cohort:   None (full participation, or UPP) or a
                  ``repro_torch.federated.sampling.CohortSpec``: every
                  engine then trains only the spec's per-round cohort,
                  drawn from a keyed side-channel generator (needs
                  ``upp=1.0``).
        server_momentum: cloud momentum on the aggregated model delta
                  (0.0: plain FedAvg).
        distill:  an ``engine.distill.DistillSpec`` for the fuse of a
                  heterogeneous-model population; None takes the
                  scenario's default.  Ignored for a homogeneous one.  A
                  heterogeneous population takes no ``cohort``,
                  ``server_momentum``, ``track_divergence``, and, on the
                  readable simulator, no ``wall_clock`` or faults
                  (``ValueError``).
        track_divergence: the distance to a virtual centralized model
                  (eq. 17) in each round's ``divergence`` (not with
                  ``engine="async"``).
        telemetry: the observability knob: None/False — off; True — record
                  in memory (``SimResult.telemetry``); a path — record and
                  write ``trace.json``, ``trace.jsonl``, ``rounds.jsonl``,
                  ``metrics.json`` and ``summary.txt`` there when the run
                  ends (also when it raises); a
                  ``repro_torch.telemetry.Telemetry`` — record into it.
        serve:    a ``repro_torch.serving.TrafficSpec``: after each cloud
                  round the global model is hot-swapped behind a
                  deterministic query stream drawn from the clients'
                  shards, and each round reports ``serve_qps``,
                  ``serve_staleness_rounds`` and ``serve_acc``
                  (``SimResult.serve_history``; under telemetry also the
                  round records and gauges).  The queries come from a keyed
                  side-channel generator, so a run trains exactly as it
                  would without them.  Homogeneous populations only.
        device:   where the engine runs; "cuda" by default, raising without
                  CUDA unless "cpu" is asked for.
        """
        if engine not in ("reference", "sync", "async"):
            raise ValueError(f"unknown engine {engine!r} (reference | sync | async)")
        distill = distill if distill is not None else self.distill
        hetero = self.is_hetero
        if hetero and (cohort is not None or server_momentum):
            raise ValueError(
                "cohort sampling / server momentum are not supported for heterogeneous-model populations"
            )
        spec = self.faults if faults is None else (faults or None)
        fault_state = None
        if spec is not None:
            if not isinstance(spec, FaultSpec):
                raise TypeError(f"faults must be a repro_torch.faults.FaultSpec, got {type(spec).__name__}")
            fault_state = FaultState(
                spec, self.topo, self.wp, self.model_bits, class_counts=self.class_counts, device=device
            )
        tel = coerce_telemetry(telemetry)
        serve_state = None
        if serve is not None:
            if not isinstance(serve, TrafficSpec):
                raise TypeError(f"serve must be a repro_torch.serving.TrafficSpec, got {type(serve).__name__}")
            if hetero:
                raise ValueError(
                    "serve traffic targets THE global model; heterogeneous-model populations have one per group"
                )
            serve_state = ServeTraffic(serve, self.clients, self.program, tel, device=device)
        try:
            sim = self._engine(
                assignment, schedule, seed, upp, track_divergence, wall_clock, engine, backend, compression,
                staleness_decay, quorum, pipeline, distill, fault_state, tel, cohort, server_momentum, serve_state,
                mesh, device,
            )
            res = sim.run(cloud_rounds, eval_every=eval_every)
            if hasattr(sim, "comm_report"):  # the mesh engine's collective bytes
                res.comm_report = sim.comm_report()
            return res
        finally:
            if tel is not None and tel.out_dir is not None:
                tel.flush()

    def _engine(
        self, assignment, schedule, seed, upp, track_divergence, wall_clock, engine, backend, compression,
        staleness_decay, quorum, pipeline, distill, fault_state, tel, cohort, server_momentum, serve, mesh, device,
    ):
        """The engine ``simulate`` runs, built from its checked options."""
        hetero = self.is_hetero
        cost_latency = self.cost.latency if wall_clock else None
        if engine == "reference" and hetero:
            if track_divergence or wall_clock:
                raise ValueError("track_divergence/wall_clock are not defined for heterogeneous-model populations")
            if fault_state is not None:
                raise ValueError(
                    "the hetero reference simulator does not support fault injection; use engine='sync' "
                    "or 'async' for heterogeneous-model populations under faults"
                )
            return HeteroHFLSimulation(
                self.clients,
                assignment,
                self.test,
                schedule=schedule,
                seed=seed,
                upp=upp,
                public=self.public,
                distill=distill,
                compression=compression,
                telemetry=tel,
                device=device,
            )
        if engine == "reference":
            return HFLSimulation(
                self.clients,
                assignment,
                self.program,
                self.test,
                schedule=schedule,
                seed=seed,
                upp=upp,
                track_divergence=track_divergence,
                cost_latency=cost_latency,
                compression=compression,
                faults=fault_state,
                telemetry=tel,
                cohort=cohort,
                server_momentum=server_momentum,
                serve=serve,
                device=device,
            )
        if engine == "async":
            from repro_torch.engine.async_sim import AsyncHFLEngine

            if track_divergence:
                raise ValueError("engine='async' does not support track_divergence; use engine='reference' or 'sync'")
            return AsyncHFLEngine(
                self.clients,
                assignment,
                self.program,
                self.test,
                latency=self.cost.latency,
                schedule=schedule,
                seed=seed,
                upp=upp,
                staleness_decay=staleness_decay,
                quorum=quorum,
                backend=backend,
                compression=compression,
                public_shards=self.public,
                distill=distill,
                faults=fault_state,
                telemetry=tel,
                cohort=cohort,
                server_momentum=server_momentum,
                serve=serve,
                device=device,
            )
        from repro_torch.engine.mesh_sim import MeshSyncEngine
        from repro_torch.engine.sync_sim import BatchedSyncEngine

        if pipeline == "mesh" or mesh is not None:
            return MeshSyncEngine(
                self.clients,
                assignment,
                self.program,
                self.test,
                schedule=schedule,
                seed=seed,
                upp=upp,
                track_divergence=track_divergence,
                cost_latency=cost_latency,
                backend=backend,
                compression=compression,
                faults=fault_state,
                telemetry=tel,
                cohort=cohort,
                server_momentum=server_momentum,
                mesh=mesh,
                serve=serve,
                device=device,
            )
        return BatchedSyncEngine(
            self.clients,
            assignment,
            self.program,
            self.test,
            schedule=schedule,
            seed=seed,
            upp=upp,
            track_divergence=track_divergence,
            cost_latency=cost_latency,
            backend=backend,
            compression=compression,
            pipeline=pipeline,
            public_shards=self.public,
            distill=distill,
            faults=fault_state,
            cohort=cohort,
            server_momentum=server_momentum,
            telemetry=tel,
            serve=serve,
            device=device,
        )

    def centralized(self, rounds: int, seed: int = 0, eval_every: int = 1, device="cuda") -> List[RoundMetrics]:
        """The centralized baseline at the paper's batch: the local batch
        times the edge count (50 for heartbeat, 30 for seizure)."""
        return centralized_baseline(
            self.clients, self.program, self.test, rounds, batch=10 * self.n_edges, seed=seed,
            eval_every=eval_every, device=device,
        )


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


def _mix_programs(model_mix: Mapping[str, int], n_eus: int, allowed: Sequence[str], make) -> tuple:
    """A ``model_mix`` mapping as one program per EU, and the distinct
    programs.  The counts must each be >= 1 and sum to the population;
    EUs take programs in mapping order (the first ``model_mix[a]`` EUs run
    ``a``, the next block ``b``, ...), so the capability skew lands on a
    deterministic slice of the population.  ``make`` builds the program of
    one name."""
    if not model_mix:
        raise ValueError("model_mix must name at least one program")
    unknown = set(model_mix) - set(allowed)
    if unknown:
        raise ValueError(f"model_mix programs {sorted(unknown)} not supported here; allowed: {sorted(allowed)}")
    counts = {name: int(c) for name, c in model_mix.items()}
    if any(c < 1 for c in counts.values()):
        raise ValueError(f"model_mix counts must be >= 1, got {model_mix}")
    if sum(counts.values()) != n_eus:
        raise ValueError(f"model_mix counts must sum to the population size {n_eus}, got {sum(counts.values())}")
    programs = {name: make(name) for name in counts}
    per_eu: List[ClientProgram] = []
    for name, c in counts.items():
        per_eu += [programs[name]] * c
    return per_eu, list(programs.values())


def build_scenario(
    dataset: str = "heartbeat",
    *,
    model: str = "cnn",
    model_mix: Optional[Mapping[str, int]] = None,
    public_per_edge: int = 16,
    fedsgd: bool = False,
    grad_bits: int = 32,
    hparams: Optional[Sequence[Optional[Mapping]]] = None,
    faults=None,
    seed: int = 0,
    scale: float = 1.0,
    mean_dist: float = 300.0,
    n_test_per_class: int = 300,
    wp: Optional[WirelessParams] = None,
    lm_eus: int = 12,
    lm_edges: int = 4,
    lm_topics: int = 4,
    lm_seq_len: int = 32,
    lm_vocab: int = 128,
    lazy: bool = False,
    n_eus: Optional[int] = None,
    n_edges: Optional[int] = None,
    device="cuda",
):
    """The paper's heartbeat or seizure setup, or the token-stream LM
    population.

    ``dataset`` picks the shards ("heartbeat" | "seizure" | "lm") and
    ``model`` the client program: "cnn" (the paper's) or "mlp" (a
    flattened-feature classifier on the same shards), or "lm" or "moe",
    the dense or mixture-of-experts transformer LM on the topic-skewed
    token shards (``dataset="lm"`` implied; ``dataset="lm"`` defaults the
    model to "lm").  ``fedsgd=True``
    wraps the program in ``FedSGDProgram`` (one plain-SGD step per round, a
    gradient uplink of ``grad_bits`` = 32 or 16 bits per parameter).
    ``hparams`` (optional) is one mapping per EU of ``FLClient`` overrides
    (``lr`` | ``batch_size`` | ``local_epochs`` | ``max_steps``).  The cost
    matrices are evaluated on ``device`` ("cuda" by default; raises without
    CUDA unless "cpu").  ``faults`` (a ``repro_torch.faults.FaultSpec``) is
    the scenario's default fault model, which ``simulate`` applies unless
    told otherwise.

    The LM population has ``lm_eus`` EUs over ``lm_edges`` edges, each shard
    dominated by one of ``lm_topics`` Markov topics, with ``lm_seq_len``
    long sequences over ``lm_vocab`` tokens; ``scale`` sizes the shards.

    ``model_mix`` (instead of ``model``) builds a heterogeneous-MODEL
    population: program names to EU counts summing to the population, e.g.
    ``{"cnn": 12, "mlp": 6}``.  The scenario then carries one public shard
    per edge (``public_per_edge // classes`` samples of each class) and a
    default ``engine.distill.DistillSpec``; ``model_bits`` is the largest
    architecture's.  A one-program mix is the homogeneous population
    (``{"lm": 12}`` on the LM population).  A mix of sequence programs
    (``{"lm": 8, "moe": 4}``) draws one public token pool per edge
    (``public_per_edge // lm_topics`` sequences of each topic).

    ``lazy=True`` builds a streaming population of ``n_eus`` clients over
    ``n_edges`` edges (default 8) instead: a ``federated.stream.
    StreamScenario`` whose shards are synthesized on demand, assigned by
    analytic striping, and simulated by ``StreamSyncEngine`` over a sampled
    cohort (``simulate(CohortSpec(...))``).  It takes no ``faults``,
    ``model_mix`` or ``hparams`` (per-client state, O(M)).
    """
    resolve_device(device)
    if lazy:
        if model_mix is not None or hparams is not None or faults is not None:
            raise ValueError(
                "lazy mode supports homogeneous fault-free populations "
                "(model_mix/hparams/faults are per-client state, O(M))"
            )
        if n_eus is None:
            raise ValueError("lazy mode requires n_eus= (population size)")
        return build_stream_scenario(
            dataset,
            n_eus=n_eus,
            n_edges=n_edges if n_edges is not None else 8,
            model=model,
            fedsgd=fedsgd,
            grad_bits=grad_bits,
            seed=seed,
            n_test_per_class=n_test_per_class,
            lm_topics=lm_topics,
            lm_seq_len=lm_seq_len,
            lm_vocab=lm_vocab,
        )
    if n_eus is not None or n_edges is not None:
        raise ValueError("n_eus/n_edges are lazy-mode knobs (pass lazy=True)")
    if model_mix is not None and fedsgd:
        raise ValueError("model_mix and fedsgd cannot combine (pick one)")
    if model_mix is not None and model != "cnn":  # "cnn" is the unset default
        raise ValueError(f"pass either model= or model_mix=, not both (got model={model!r})")
    seq_model = model in SEQUENCE_PROGRAMS
    seq_mix = model_mix is not None and set(model_mix) <= set(SEQUENCE_PROGRAMS)
    if model_mix is not None and not seq_mix:
        bad = set(model_mix) & set(SEQUENCE_PROGRAMS)
        if bad:
            raise ValueError(
                "model_mix cannot cross families: sequence programs "
                f"{sorted(bad)} do not share a shard layout with {sorted(set(model_mix) - bad)}"
            )
        if dataset == "lm":
            raise ValueError(f"dataset='lm' requires a sequence model_mix {SEQUENCE_PROGRAMS}, got {sorted(model_mix)}")
    if dataset == "lm" or seq_model or seq_mix:
        if not (seq_model or seq_mix) and model != "cnn":  # "cnn" is the unset default
            raise ValueError(f"dataset='lm' requires a sequence model {SEQUENCE_PROGRAMS}, got {model!r}")
        return _build_lm_scenario(
            model=model if seq_model else "lm",
            model_mix=model_mix if seq_mix else None,
            public_per_edge=public_per_edge,
            fedsgd=fedsgd,
            grad_bits=grad_bits,
            hparams=hparams,
            faults=faults,
            seed=seed,
            scale=scale,
            mean_dist=mean_dist,
            n_test_per_class=n_test_per_class,
            wp=wp,
            n_eus=lm_eus,
            n_edges=lm_edges,
            n_topics=lm_topics,
            seq_len=lm_seq_len,
            vocab=lm_vocab,
            device=device,
        )
    if model not in ("cnn", "mlp"):
        raise ValueError(f"unknown model {model!r} (cnn | mlp | {' | '.join(SEQUENCE_PROGRAMS)})")
    rng = np.random.default_rng(seed)
    if dataset == "heartbeat":
        table, n_eus, cnn, maker = TABLE3_HEARTBEAT, 18, HEARTBEAT_CNN, heartbeat_like
    elif dataset == "seizure":
        table, n_eus, cnn, maker = TABLE2_SEIZURE, 13, SEIZURE_CNN, seizure_like
    else:
        raise ValueError(dataset)
    n_edges, k = table.shape
    counts, init_edge = eu_counts_from_edge_table(
        rng, table, _eus_per_edge(n_edges, n_eus), scale=scale
    )
    train = maker(rng, counts.sum(axis=0))
    shards = split_dataset_by_counts(rng, train, counts)
    test = maker(rng, np.full(k, n_test_per_class))

    def make_health(name: str) -> ClientProgram:
        if name == "cnn":
            return CNNProgram(cnn)
        return MLPProgram(feat=(cnn.seq_len, cnn.in_channels), classes=k)

    public = distill = None
    if model_mix is not None:
        per_eu, distinct = _mix_programs(model_mix, n_eus, ("cnn", "mlp"), make_health)
        program = per_eu[0]
        if len(distinct) > 1:
            # one small public pool per edge, drawn AFTER the private shards
            # and the test set, so those stay byte-equal to the homogeneous
            # builder's at the same seed
            per_class = np.full(k, max(1, public_per_edge // k))
            public = [maker(rng, per_class) for _ in range(n_edges)]
            distill = DistillSpec()
    else:
        program = make_health(model)
        if fedsgd:
            program = FedSGDProgram(base=program, grad_bits=grad_bits)
        per_eu, distinct = [program] * n_eus, [program]
    if len(distinct) > 1:
        name = f"{dataset}-mix(" + "+".join(model_mix) + ")"
    else:
        name = dataset if program.name == "cnn" else f"{dataset}-{program.name}"
    return _assemble(
        name, program, per_eu, distinct, shards, test, counts, init_edge, hparams, faults, seed, mean_dist, wp,
        n_edges, public, distill, device,
    )


def _assemble(
    name, program, per_eu, distinct, shards, test, counts, init_edge, hparams, faults, seed, mean_dist, wp, n_edges,
    public, distill, device,
) -> Scenario:
    """The clients, topology and cost model of a population, as a
    ``Scenario``.  The topology and the payload size come from a
    ``torch.Generator`` seeded from ``seed``, which never touches the data
    stream.  ``init_edge`` None is each EU's nearest edge."""
    n_eus = len(shards)
    kw = _hparam_kwargs(hparams, n_eus)
    clients = [FLClient(i, shards[i], per_eu[i], **kw[i]) for i in range(n_eus)]
    wp = wp or WirelessParams()
    gen = torch.Generator().manual_seed(seed)
    topo = sample_topology(
        gen, n_eus, n_edges, mean_dist=mean_dist, dataset_sizes=counts.sum(axis=1)
    )
    # a mixed fleet sizes EARA's airtime by its LARGEST architecture
    model_bits = max(tree_size_bytes(p.init(gen)) * 8 for p in distinct)
    cost = build_cost_matrices(topo, model_bits, wp, device=device)
    return Scenario(
        name=name,
        program=program,
        clients=clients,
        test=test,
        class_counts=counts,
        topo=topo,
        cost=cost,
        wp=wp,
        model_bits=model_bits,
        init_edge=init_edge if init_edge is not None else np.asarray(topo.dist).argmin(axis=1),
        public=public,
        distill=distill,
        faults=faults,
    )


def _build_lm_scenario(
    *,
    model: str,
    model_mix: Optional[Mapping[str, int]],
    public_per_edge: int,
    fedsgd: bool,
    grad_bits: int,
    hparams: Optional[Sequence[Optional[Mapping]]],
    faults,
    seed: int,
    scale: float,
    mean_dist: float,
    n_test_per_class: int,
    wp: Optional[WirelessParams],
    n_eus: int,
    n_edges: int,
    n_topics: int,
    seq_len: int,
    vocab: int,
    device,
) -> Scenario:
    """The topic-skewed token-stream population of the sequence programs.

    Each EU's shard is dominated by one Markov topic (the ``lm_stream``
    transition families) with a sprinkle of the others, the LM counterpart
    of the paper's per-EU dominant-class imbalance, recorded in
    ``class_counts`` so that EARA balances edge topic mixtures as it
    balances class mixtures.  Shards are (N, seq_len) int32 and byte-equal
    to the reference's at the same arguments.  A mix of more than one
    program adds one public token pool per edge from fresh streams (seed +
    3571), drawn after everything else, and the default ``DistillSpec``.
    """
    rng = np.random.default_rng(seed)
    base = max(1, int(round(40 * scale)))
    # the dominant topic gets ~8x the sideline topics' sequence counts
    counts = rng.integers(0, base + 1, (n_eus, n_topics)).astype(np.int64)
    dom = rng.integers(0, n_topics, n_eus)
    counts[np.arange(n_eus), dom] += 8 * base
    streams = [TokenStream(vocab, seed=seed, topic=t) for t in range(n_topics)]
    shards = []
    for i in range(n_eus):
        xs, ys = [], []
        for t in range(n_topics):
            c = int(counts[i, t])
            if c == 0:
                continue
            xs.append(streams[t].batch(c, seq_len))
            ys.append(np.full((c,), t, np.int32))
        x = np.concatenate(xs, 0)
        y = np.concatenate(ys, 0)
        perm = rng.permutation(len(y))
        shards.append(Dataset(x[perm], y[perm], n_classes=n_topics))
    # fresh streams for the test set, so it never replays training state
    test_streams = [TokenStream(vocab, seed=seed + 7919, topic=t) for t in range(n_topics)]
    test = Dataset(
        np.concatenate([s.batch(n_test_per_class, seq_len) for s in test_streams], 0),
        np.concatenate([np.full((n_test_per_class,), t, np.int32) for t in range(n_topics)], 0),
        n_classes=n_topics,
    )

    def make_seq(name: str) -> ClientProgram:
        return PROGRAMS.get(name)(vocab_size=vocab, seq_len=seq_len, n_topics=n_topics)

    public = distill = None
    if model_mix is not None:
        per_eu, distinct = _mix_programs(model_mix, n_eus, SEQUENCE_PROGRAMS, make_seq)
        program = per_eu[0]
        if len(distinct) > 1:
            # per-edge public token pools from fresh streams (never replaying
            # training or test state), drawn after everything else
            pub_streams = [TokenStream(vocab, seed=seed + 3571, topic=t) for t in range(n_topics)]
            per_topic = max(1, public_per_edge // n_topics)
            public = [
                Dataset(
                    np.concatenate([s.batch(per_topic, seq_len) for s in pub_streams], 0),
                    np.concatenate([np.full((per_topic,), t, np.int32) for t in range(n_topics)], 0),
                    n_classes=n_topics,
                )
                for _ in range(n_edges)
            ]
            distill = DistillSpec()
    else:
        program = make_seq(model)
        if fedsgd:
            program = FedSGDProgram(base=program, grad_bits=grad_bits)
        per_eu, distinct = [program] * n_eus, [program]
    name = "mix(" + "+".join(model_mix) + ")" if len(distinct) > 1 else program.name
    return _assemble(
        name, program, per_eu, distinct, shards, test, counts, None, hparams, faults,
        seed, mean_dist, wp, n_edges, public, distill, device,
    )
