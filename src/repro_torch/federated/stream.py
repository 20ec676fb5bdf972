"""Streaming population scenarios: lazy shards, analytic assignment.

The eager ``build_scenario`` materializes every shard before assignment;
this module is its lazy counterpart for populations far past what host
memory holds (M = 100k-1M):

  * :func:`striped_assignment` — the EARA objective (least per-edge KLD to
    uniform, paper eq. 19) solved analytically: clients are striped round
    robin across edges within each dominant-class family, so every edge's
    class histogram approaches the population's, computed in O(M) chunks
    from the source's analytic class counts (no LP, no (M, N) matrix, no
    data);
  * :class:`StreamScenario` — the streaming ``Scenario``: a ``ShardSource``,
    a compact (M,) ``edge_of`` assignment and the exact per-edge class
    histograms; ``simulate`` runs ``StreamSyncEngine``;
  * :class:`LazyClientList` — a sequence that builds ``FLClient`` objects
    on access (small-M parity runs materialize through it; the streaming
    engine never touches client objects).

``build_scenario(lazy=True, n_eus=...)`` lands here, for the health
shards (``HealthShardSource``) or, with ``dataset="lm"`` or ``model="lm"``,
the token-stream population (``TokenShardSource``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.hfl import HFLSchedule
from repro_torch.data.shard_source import HealthShardSource, ShardSource, TokenShardSource
from repro_torch.data.synthetic_health import Dataset, make_dataset
from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import (
    PROGRAMS,
    SEQUENCE_PROGRAMS,
    CNNProgram,
    FedSGDProgram,
    MLPProgram,
    as_program,
)
from repro_torch.federated.sampling import CohortSpec
from repro_torch.federated.simulation import SimResult
from repro_torch.models.cnn1d import HEARTBEAT_CNN, SEIZURE_CNN
from repro_torch.telemetry import coerce_telemetry
from repro_torch.utils.seedhash import keyed_randint
from repro_torch.utils.tree import tree_size_bytes

_CHUNK = 1 << 16
_S_TEST = 0x7E57  # test-set RNG key component (disjoint from client keys)

ASSIGN_STRATEGIES = ("striped", "hash")


def striped_assignment(source: ShardSource, n_edges: int, strategy: str = "striped") -> np.ndarray:
    """(M,) int32 edge id per client, computed in chunks.

    ``striped`` spreads each dominant-class family round robin across the
    edges, so per-edge histograms approach the population histogram, which
    minimizes the per-edge KLD-to-uniform objective as well as any
    assignment of these clients can.  ``hash`` is the keyed-random
    baseline (the DBA analogue), kept for KLD comparisons.
    """
    m = source.n_clients
    edge_of = np.empty(m, np.int32)
    if strategy == "hash":
        for lo in range(0, m, _CHUNK):
            hi = min(lo + _CHUNK, m)
            edge_of[lo:hi] = keyed_randint(source.seed, 0xED6E, np.arange(lo, hi), n_edges)
        return edge_of
    if strategy != "striped":
        raise ValueError(f"assignment strategy must be one of {ASSIGN_STRATEGIES}")
    next_slot = np.zeros(source.n_classes, np.int64)  # per-family rotation
    for lo in range(0, m, _CHUNK):
        hi = min(lo + _CHUNK, m)
        dom = source.dominant_block(lo, hi)
        for c in range(source.n_classes):
            sel = np.flatnonzero(dom == c)
            if not len(sel):
                continue
            edge_of[lo + sel] = (next_slot[c] + np.arange(len(sel))) % n_edges
            next_slot[c] += len(sel)
    return edge_of


def edge_kld_uniform(edge_hist: np.ndarray) -> float:
    """sum_j D_KL(H_j || Uniform) from exact (N, K) edge histograms: the
    paper's P1 objective (eq. 19), scored analytically."""
    eps = 1e-12
    h = edge_hist / np.maximum(edge_hist.sum(axis=1, keepdims=True), eps)
    h = np.maximum(h, eps)
    k = edge_hist.shape[1]
    return float(np.sum(h * (np.log(h) - np.log(1.0 / k))))


class LazyClientList:
    """Sequence of ``FLClient`` built on access from a ``ShardSource``."""

    def __init__(self, source: ShardSource, program, **client_kwargs):
        self.source = source
        self.program = program
        self.kwargs = client_kwargs

    def __len__(self) -> int:
        return self.source.n_clients

    def __getitem__(self, cid: int) -> FLClient:
        if not 0 <= cid < len(self):
            raise IndexError(cid)
        return FLClient(int(cid), self.source.shard(int(cid)), self.program, **self.kwargs)

    def __iter__(self):
        for cid in range(len(self)):
            yield self[cid]


@dataclasses.dataclass
class StreamScenario:
    """The streaming ``Scenario``: population-level metadata only.

    ``edge_class_counts`` is the exact (N, K) per-edge class histogram
    (analytic: no data materialized), which scores the assignment as the
    eager scenario's ``class_counts`` do.
    """

    name: str
    program: object
    source: ShardSource
    test: Dataset
    edge_of: np.ndarray  # (M,) int32
    edge_class_counts: np.ndarray  # (N, K)
    model_bits: float
    batch_size: int = 10
    lr: float = 1e-3
    max_steps: int = 128

    @property
    def n_clients(self) -> int:
        return self.source.n_clients

    @property
    def n_edges(self) -> int:
        return self.edge_class_counts.shape[0]

    def kld_total(self) -> float:
        return edge_kld_uniform(self.edge_class_counts)

    def clients(self) -> LazyClientList:
        return LazyClientList(
            self.source, self.program, batch_size=self.batch_size, lr=self.lr, max_steps=self.max_steps
        )

    def assignment_matrix(self, limit: int = 1 << 14) -> np.ndarray:
        """The dense (M, N) matrix, for small-M parity runs; refused above
        ``limit`` clients so that a 1M population cannot allocate it by
        accident."""
        if self.n_clients > limit:
            raise ValueError(
                f"refusing to densify assignment for M={self.n_clients} "
                f"(> {limit}); the streaming engine works off edge_of"
            )
        lam = np.zeros((self.n_clients, self.n_edges), np.int8)
        att = self.edge_of >= 0
        lam[np.flatnonzero(att), self.edge_of[att]] = 1
        return lam

    def simulate(
        self,
        cohort: CohortSpec,
        cloud_rounds: int = 10,
        schedule: HFLSchedule = HFLSchedule(1, 1),
        seed: int = 0,
        backend: str = "kernel",
        page_slots: Optional[int] = None,
        server_momentum: float = 0.0,
        eval_every: int = 1,
        telemetry=None,
        device="cuda",
    ) -> SimResult:
        """Run ``StreamSyncEngine`` on this population (``device``: "cuda"
        by default, raising without CUDA unless "cpu").  ``telemetry`` is
        ``Scenario.simulate``'s knob: a directory gets the artifacts when
        the run ends, also when it raises."""
        from repro_torch.engine.stream_sim import StreamSyncEngine

        tel = coerce_telemetry(telemetry)
        try:
            eng = StreamSyncEngine(
                self.source, self.edge_of, self.program, self.test,
                cohort=cohort, n_edges=self.n_edges, schedule=schedule, seed=seed,
                backend=backend, page_slots=page_slots,
                batch_size=self.batch_size, lr=self.lr, max_steps=self.max_steps,
                server_momentum=server_momentum, telemetry=tel, device=device,
            )
            return eng.run(cloud_rounds, eval_every=eval_every)
        finally:
            if tel is not None and tel.out_dir is not None:
                tel.flush()


def build_stream_scenario(
    dataset: str = "heartbeat",
    *,
    n_eus: int,
    n_edges: int = 8,
    model: str = "cnn",
    fedsgd: bool = False,
    grad_bits: int = 32,
    seed: int = 0,
    assign: str = "striped",
    n_test_per_class: int = 300,
    max_per_class: int = 2,
    dom_boost: int = 8,
    lm_topics: int = 4,
    lm_seq_len: int = 32,
    lm_vocab: int = 128,
) -> StreamScenario:
    """Lazy-mode ``build_scenario``: nothing O(M) but small int arrays.

    The population is a family of its own (hash-derived per-client class
    counts, per-client keyed data), not a re-derivation of the eager
    builder's pooled split, which is a function of all M draws at once.
    ``source.shard(cid)`` is pure in ``(seed, cid)``, so the lazy
    population equals its own materialization, a paged-out client comes
    back bit-identical, and every engine that materializes the source
    trains on the same bytes.  The shards, test set and assignment are
    byte-equal to the reference's at the same arguments.

    The token-stream population (``dataset="lm"`` or a sequence ``model``)
    draws ``lm_seq_len``-token sequences over ``lm_vocab`` tokens from
    ``lm_topics`` topics, and its test set is one balanced pooled draw of
    ``n_test_per_class // 4`` sequences a topic.
    """
    if model in SEQUENCE_PROGRAMS or dataset == "lm":
        prog_name = model if model in SEQUENCE_PROGRAMS else "lm"
        source = TokenShardSource(
            seed, n_eus, n_topics=lm_topics, vocab_size=lm_vocab, seq_len=lm_seq_len,
            max_per_topic=max_per_class, dom_boost=max(1, dom_boost - 2),
        )
        program = PROGRAMS.get(prog_name)(vocab_size=lm_vocab, seq_len=lm_seq_len, n_topics=lm_topics)
        test = TokenShardSource(
            seed + 1, 1, n_topics=lm_topics, vocab_size=lm_vocab, seq_len=lm_seq_len,
            min_per_topic=n_test_per_class // 4, max_per_topic=n_test_per_class // 4, dom_boost=1,
        ).shard(0)
        name = f"lm-stream-{prog_name}"
    elif dataset in ("heartbeat", "seizure"):
        cnn = HEARTBEAT_CNN if dataset == "heartbeat" else SEIZURE_CNN
        k = cnn.n_classes
        source = HealthShardSource(
            seed, n_eus, n_classes=k, length=cnn.seq_len, channels=cnn.in_channels,
            max_per_class=max_per_class, dom_boost=dom_boost,
        )
        if model == "cnn":
            program = CNNProgram(cnn)
        elif model == "mlp":
            program = MLPProgram(feat=(cnn.seq_len, cnn.in_channels), classes=k)
        else:
            raise ValueError(f"unknown model {model!r} for dataset {dataset!r}")
        test = make_dataset(
            np.random.default_rng((seed, _S_TEST)), np.full(k, n_test_per_class),
            length=cnn.seq_len, channels=cnn.in_channels,
        )
        name = f"{dataset}-stream" if model == "cnn" else f"{dataset}-stream-{model}"
    else:
        raise ValueError(dataset)
    if fedsgd:
        program = FedSGDProgram(base=program, grad_bits=grad_bits)
    program = as_program(program)
    edge_of = striped_assignment(source, n_edges, strategy=assign)
    edge_hist = source.edge_histograms(edge_of, n_edges)
    model_bits = tree_size_bytes(program.init(torch.Generator().manual_seed(0))) * 8
    return StreamScenario(
        name=name,
        program=program,
        source=source,
        test=test,
        edge_of=edge_of,
        edge_class_counts=edge_hist,
        model_bits=model_bits,
    )
