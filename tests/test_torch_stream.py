"""Streaming populations: the port's lazy shard sources, cohort sampling,
paged store, server momentum and ``StreamSyncEngine`` against the JAX
package's on the same inputs.

The numpy-only modules are copies and must give byte-equal outputs; the
engines start from the reference's initial parameters
(``torch_parity.reference_inits``) and are held to the reference's own
tolerances: accuracy 1e-6, parameters 1e-4 between the streaming and the
sync engine (another summation order), 5e-3 between engines of the two
packages (``check_run``), accountant totals exact.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.data.shard_source as ref_shard_source  # noqa: E402
import repro.federated.sampling as ref_sampling  # noqa: E402
import repro.utils.seedhash as ref_seedhash  # noqa: E402
from repro.core.hfl import HFLSchedule as RefSchedule  # noqa: E402
from repro.engine import AsyncHFLEngine as RefAsyncHFLEngine  # noqa: E402
from repro.engine import BatchedSyncEngine as RefBatchedSyncEngine  # noqa: E402
from repro.engine import PagedShardStore as RefPagedShardStore  # noqa: E402
from repro.engine import StreamSyncEngine as RefStreamSyncEngine  # noqa: E402
from repro.engine.cohort import StreamCohortPlan as RefStreamCohortPlan  # noqa: E402
from repro.federated import HFLSimulation as RefHFLSimulation  # noqa: E402
from repro.federated import build_scenario as ref_build  # noqa: E402
from repro.federated.stream import striped_assignment as ref_striped_assignment  # noqa: E402
from repro_torch.core import HFLSchedule, ServerMomentum  # noqa: E402
from repro_torch.data import shard_source  # noqa: E402
from repro_torch.data.synthetic_health import make_dataset  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    AsyncHFLEngine,
    BatchedSyncEngine,
    DeviceShardStore,
    PagedShardStore,
    StreamCohortPlan,
    StreamSyncEngine,
)
from repro_torch.federated import (  # noqa: E402
    CohortSpec,
    FLClient,
    HFLSimulation,
    build_scenario,
    striped_assignment,
)
from repro_torch.federated import sampling  # noqa: E402
from repro_torch.federated.programs import CNNProgram, FedSGDProgram, as_program  # noqa: E402
from repro_torch.models.cnn1d import CNNConfig  # noqa: E402
from repro_torch.training.optimizers import sgd  # noqa: E402
from repro_torch.utils import seedhash  # noqa: E402
from repro_torch.utils.tree import tree_ravel, tree_spec, tree_unravel  # noqa: E402
from torch_parity import check_run, flat, reference_inits, reference_program  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
M, N_EDGES, SEED = 120, 4, 3
SCHEDULE = HFLSchedule(1, 1)
REF_SCHEDULE = RefSchedule(1, 1)
COHORT = dict(size=24, seed=9)


@pytest.fixture(scope="module")
def scenarios():
    """The lazy population in both packages; the port starts its engines
    from the reference's initial parameters."""
    kw = dict(lazy=True, n_eus=M, n_edges=N_EDGES, seed=SEED, n_test_per_class=20)
    ref = ref_build("heartbeat", **kw)
    sc = build_scenario("heartbeat", device="cpu", **kw)
    with reference_inits():
        yield ref, sc


@pytest.fixture(scope="module")
def spec():
    return CohortSpec(**COHORT)


@pytest.fixture(scope="module")
def ref_spec():
    return ref_sampling.CohortSpec(**COHORT)


@pytest.fixture(scope="module")
def stream_runs(scenarios, spec, ref_spec):
    """Three cloud rounds of each package's ``StreamSyncEngine``."""
    ref, sc = scenarios
    return (
        ref.simulate(ref_spec, cloud_rounds=3, schedule=REF_SCHEDULE, seed=0),
        sc.simulate(spec, cloud_rounds=3, schedule=SCHEDULE, seed=0, device="cpu"),
    )


@pytest.fixture(scope="module")
def materialized(scenarios):
    """The same population as ``FLClient`` lists and the dense assignment,
    in both packages."""
    ref, sc = scenarios
    lam = sc.assignment_matrix()
    np.testing.assert_array_equal(lam, ref.assignment_matrix())
    return list(ref.clients()), list(sc.clients()), lam


# -- the copied modules: byte-equal outputs ------------------------------------
def test_lm_stream_is_the_reference_file():
    port, ref = (ROOT / "src/repro_torch/data/lm_stream.py"), (ROOT / "src/repro/data/lm_stream.py")
    assert port.read_bytes() == ref.read_bytes()


def test_keyed_hashes_byte_equal():
    idx = np.concatenate([np.arange(1000), np.array([2**40, 2**63 - 1], np.int64)])
    for seed, stream in ((0, 0), (3, 0x5EED_0001), (2**40 + 7, 0xC0_4082)):
        assert np.array_equal(seedhash.keyed_hash(seed, stream, idx), ref_seedhash.keyed_hash(seed, stream, idx))
        assert np.array_equal(seedhash.keyed_uniform(seed, stream, idx), ref_seedhash.keyed_uniform(seed, stream, idx))
        for n in (1, 5, 8, 1000):
            got = seedhash.keyed_randint(seed, stream, idx, n)
            assert got.dtype == np.int64 and np.array_equal(got, ref_seedhash.keyed_randint(seed, stream, idx, n))


@pytest.mark.parametrize("kind", ["health", "token"])
def test_shard_sources_byte_equal(kind):
    """Sizes, analytic class counts, dominant classes and synthesized shards
    equal the reference's, array for array."""
    if kind == "health":
        kw = dict(n_classes=5, length=187, channels=1, max_per_class=2, dom_boost=8)
        port, ref = shard_source.HealthShardSource(5, 300, **kw), ref_shard_source.HealthShardSource(5, 300, **kw)
    else:
        kw = dict(n_topics=4, vocab_size=128, seq_len=16, max_per_topic=2, dom_boost=6)
        port, ref = shard_source.TokenShardSource(5, 300, **kw), ref_shard_source.TokenShardSource(5, 300, **kw)
    assert np.array_equal(port.sizes, ref.sizes) and port.sizes.dtype == ref.sizes.dtype
    assert np.array_equal(port.class_counts_block(17, 211), ref.class_counts_block(17, 211))
    assert np.array_equal(port.dominant_block(0, 300), ref.dominant_block(0, 300))
    assert np.array_equal(port.population_histogram(), ref.population_histogram())
    for cid in (0, 1, 150, 299):
        a, b = port.shard(cid), ref.shard(cid)
        assert a.x.dtype == b.x.dtype and np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)


@pytest.mark.parametrize("strategy", ["striped", "hash"])
def test_assignment_and_histograms_byte_equal(scenarios, strategy):
    ref, sc = scenarios
    eo = striped_assignment(sc.source, N_EDGES, strategy=strategy)
    assert np.array_equal(eo, ref_striped_assignment(ref.source, N_EDGES, strategy=strategy))
    assert np.array_equal(sc.source.edge_histograms(eo, N_EDGES), ref.source.edge_histograms(eo, N_EDGES))
    if strategy == "striped":
        assert np.array_equal(sc.edge_of, ref.edge_of) and np.array_equal(sc.edge_class_counts, ref.edge_class_counts)
        assert sc.kld_total() == ref.kld_total()
        assert np.array_equal(sc.test.x, ref.test.x) and np.array_equal(sc.test.y, ref.test.y)
        assert sc.model_bits == ref.model_bits and sc.name == ref.name


@pytest.mark.parametrize("strategy", ["uniform", "prate", "per_edge"])
def test_cohort_draws_byte_equal(scenarios, strategy):
    """``CohortSpec.draw`` (all eligible and a subset) and ``mask`` (dense
    assignment and compact ``edge_of``) equal the reference's."""
    ref, sc = scenarios
    port, want = CohortSpec(size=20, strategy=strategy, seed=2), ref_sampling.CohortSpec(
        size=20, strategy=strategy, seed=2
    )
    lam = sc.assignment_matrix()
    subset = np.flatnonzero(np.arange(M) % 3 != 0)
    for b, er in ((0, 1), (1, 1), (2, 3)):
        for eligible in (None, subset):
            got = port.draw(b, er, eligible=eligible, edge_of=sc.edge_of, m=M)
            assert np.array_equal(got, want.draw(b, er, eligible=eligible, edge_of=sc.edge_of, m=M))
        assert np.array_equal(port.mask(b, er, assignment=lam), want.mask(b, er, assignment=lam))
        assert np.array_equal(port.mask(b, er, edge_of=sc.edge_of), want.mask(b, er, edge_of=ref.edge_of))
    assert np.array_equal(sampling.pareto_weights(2, M, 1.5), ref_sampling.pareto_weights(2, M, 1.5))
    for n, k in ((10, 10), (1000, 7)):
        a = sampling._floyd_sample(np.random.default_rng(n), n, k)
        assert np.array_equal(a, ref_sampling._floyd_sample(np.random.default_rng(n), n, k))
    caps = np.array([0, 3, 9, 1, 5])
    assert np.array_equal(sampling._largest_remainder(11, caps), ref_sampling._largest_remainder(11, caps))


# -- the paged store ---------------------------------------------------------
def test_paged_store_matches_device_store_under_eviction(scenarios):
    """Waves of cohorts through a 6-slot store return the bytes the port's
    O(M) ``DeviceShardStore`` holds, and the paging counters equal the
    reference store's on the same calls."""
    _, sc = scenarios
    shards = sc.source.materialize(range(16))
    dev = DeviceShardStore.from_shards(shards, "cpu")
    paged = PagedShardStore.from_shards(shards, capacity=6, device="cpu")
    ref = RefPagedShardStore.from_shards(shards, capacity=6)
    rng = np.random.default_rng(0)
    for _ in range(6):
        cids = np.sort(rng.choice(16, size=5, replace=False))
        idx = np.stack([rng.integers(0, len(shards[c]), size=(2, 4)) for c in cids])
        dx, dy = dev.gather(cids, idx)
        px, py = paged.gather(cids, idx)
        rx, ry = ref.gather(cids, idx)
        assert torch.equal(dx, px) and torch.equal(dy, py)
        assert np.array_equal(px.numpy(), np.asarray(rx)) and np.array_equal(py.numpy(), np.asarray(ry))
        assert (paged.hits, paged.misses, paged.evictions) == (ref.hits, ref.misses, ref.evictions)
    assert paged.evictions > 0
    assert paged.device_bytes == 6 * paged.n_max * (187 * 4 + 8)


def test_paged_store_lru_counters():
    """The reference's LRU sequence, on both stores: equal counters and the
    same refusal of a cohort larger than the slab."""
    src = shard_source.HealthShardSource(1, 5, length=16)
    port = PagedShardStore(src, capacity=2, device="cpu")
    ref = RefPagedShardStore(ref_shard_source.HealthShardSource(1, 5, length=16), capacity=2)
    for cids in ([0, 1], [2], [1], [0], [3], [0]):
        assert np.array_equal(port.ensure(cids), ref.ensure(cids))
    assert (port.hits, port.misses, port.evictions) == (ref.hits, ref.misses, ref.evictions) == (2, 5, 3)
    for store in (port, ref):
        with pytest.raises(ValueError, match="capacity"):
            store.ensure([0, 1, 2])


def test_stream_cohort_plan_draws_as_the_reference(scenarios):
    """Groups, step buckets, batch indices and passthrough members equal
    the reference plan's from one numpy seed, round after round."""
    ref, sc = scenarios
    port_plan = StreamCohortPlan(sc.source.sizes, sc.program)
    ref_plan = RefStreamCohortPlan(ref.source.sizes, reference_program(sc.program))
    rng_p, rng_r = np.random.default_rng(4), np.random.default_rng(4)
    spec = CohortSpec(size=30, seed=1)
    for b in range(1, 4):
        members = spec.draw(b, 1, eligible=None, m=M)
        got, got_pass = port_plan.draw(rng_p, members, epochs=2)
        want, want_pass = ref_plan.draw(rng_r, members, epochs=2)
        assert np.array_equal(got_pass, want_pass)
        assert [(g.steps, g.batch, g.lr) for g in got] == [(g.steps, g.batch, g.lr) for g in want]
        for g, w in zip(got, want):
            assert np.array_equal(g.members, w.members) and np.array_equal(g.idx, w.idx)
        assert np.array_equal(port_plan.steps_for(members), ref_plan.steps_for(members))
    assert rng_p.integers(1 << 30) == rng_r.integers(1 << 30)  # the same draws were consumed


# -- the streaming engine ---------------------------------------------------
def test_stream_engine_matches_reference(stream_runs):
    """``StreamSyncEngine`` against the JAX package's: accuracy 1e-6,
    parameters 1e-4, accountant totals and per-EU traffic exact."""
    want, got = stream_runs
    check_run(want, got, param_tol=1e-4)


def test_stream_engine_matches_sync_engine_on_cohort_rounds(scenarios, spec, stream_runs, materialized):
    """The streaming engine against the port's own sync engine with
    ``cohort=`` on the materialized population: the same cohorts and
    batches, the FedAvg in another summation order."""
    _, sc = scenarios
    _, clients, lam = materialized
    sync = BatchedSyncEngine(clients, lam, sc.program, sc.test, schedule=SCHEDULE, seed=0, cohort=spec, device="cpu")
    check_run(sync.run(3), stream_runs[1], param_tol=1e-4, flat_want=flat)


def test_stream_paging_is_invisible(scenarios, spec, stream_runs):
    """A store of cohort-size capacity evicts heavily and gives the
    bit-identical run: rehydrated shards are the same bytes."""
    _, sc = scenarios
    eng = StreamSyncEngine(
        sc.source, sc.edge_of, sc.program, sc.test, cohort=spec, n_edges=N_EDGES, schedule=SCHEDULE, seed=0,
        page_slots=24, device="cpu",
    )
    res = eng.run(3)
    assert eng.store.evictions > 0 and eng.store.capacity == 24
    assert [m.test_acc for m in res.history] == [m.test_acc for m in stream_runs[1].history]
    assert np.array_equal(flat(res.final_params), flat(stream_runs[1].final_params))


# -- cohort= and server_momentum= on the materialized engines -----------------
def _run_pair(scenarios, materialized, engine, rounds, **kw):
    """The same run in both packages on the materialized population."""
    ref, sc = scenarios
    ref_clients, clients, lam = materialized
    ref_kw = dict(kw)
    if "cohort" in kw:
        ref_kw["cohort"] = ref_sampling.CohortSpec(**COHORT)
    if engine == "async":
        lat = np.random.default_rng(5).uniform(0.01, 0.2, (M, N_EDGES))
        want = RefAsyncHFLEngine(ref_clients, lam, ref_clients[0].program, ref.test, lat, seed=0, **ref_kw).run(rounds)
        got = AsyncHFLEngine(clients, lam, sc.program, sc.test, latency=lat, seed=0, device="cpu", **kw).run(rounds)
    elif engine == "reference":
        want = RefHFLSimulation(ref_clients, lam, ref_clients[0].program, ref.test, seed=0, **ref_kw).run(rounds)
        got = HFLSimulation(clients, lam, sc.program, sc.test, seed=0, device="cpu", **kw).run(rounds)
    else:
        pipeline = engine.split("-")[1]
        want = RefBatchedSyncEngine(
            ref_clients, lam, ref_clients[0].program, ref.test, seed=0, pipeline=pipeline, **ref_kw
        ).run(rounds)
        got = BatchedSyncEngine(clients, lam, sc.program, sc.test, seed=0, pipeline=pipeline, device="cpu", **kw).run(
            rounds
        )
    return want, got


@pytest.mark.parametrize("engine", ["reference", "sync-device", "sync-host", "async"])
def test_cohort_on_every_engine_matches_reference(scenarios, spec, materialized, engine):
    want, got = _run_pair(scenarios, materialized, engine, 2, cohort=spec)
    check_run(want, got)


@pytest.mark.parametrize("engine", ["reference", "sync-device", "stream"])
def test_server_momentum_matches_reference(scenarios, spec, ref_spec, materialized, engine):
    """``server_momentum=0.9`` on the port's simulator, sync and streaming
    engines against the JAX package's, over sampled cohorts."""
    if engine == "stream":
        ref, sc = scenarios
        want = ref.simulate(ref_spec, cloud_rounds=3, schedule=REF_SCHEDULE, seed=0, server_momentum=0.9)
        got = sc.simulate(spec, cloud_rounds=3, schedule=SCHEDULE, seed=0, server_momentum=0.9, device="cpu")
        check_run(want, got, param_tol=1e-4)
        return
    want, got = _run_pair(scenarios, materialized, engine, 3, cohort=spec, server_momentum=0.9)
    check_run(want, got)


def test_server_momentum_skips_a_model_that_stood():
    """A fully starved cloud round hands back the global model itself
    (``new is old``): the velocity is left alone, not decayed with a zero
    delta, as in the reference's engines; ``mu = 0`` is plain FedAvg."""
    m = ServerMomentum(0.9)
    old, new = {"w": torch.zeros(3)}, {"w": torch.ones(3)}
    out = m(old, new)
    assert torch.equal(out["w"], torch.ones(3))
    v = m.velocity
    assert m(out, out) is out and m.velocity is v
    assert torch.allclose(m(out, {"w": torch.full((3,), 2.0)})["w"], torch.full((3,), 2.9))
    assert ServerMomentum(0.0)(old, new) is new


def test_server_momentum_matches_centralized_sgd_oracle():
    """FedSGD with cloud momentum is centralized SGD with momentum: one
    client whose shard is one batch, on one edge, so each round's
    aggregated delta is -lr * g and the cloud's ``v <- mu v + delta`` is
    ``sgd``'s ``v <- mu v + g, p <- p - lr v``, step for step."""
    cfg = CNNConfig(in_channels=1, n_classes=3, seq_len=32, c1=4, c2=4, hidden=8)
    program = as_program(FedSGDProgram(base=CNNProgram(cfg), grad_bits=32))
    shard = make_dataset(np.random.default_rng(42), np.array([4, 3, 3]), length=32, channels=1)
    test = make_dataset(np.random.default_rng(43), np.array([5, 5, 5]), length=32, channels=1)
    lr, mu, rounds = 0.05, 0.9, 5
    client = FLClient(0, shard, program, batch_size=10, lr=lr)
    sim = HFLSimulation(
        [client], np.ones((1, 1), np.int8), program, test, schedule=SCHEDULE, seed=0, server_momentum=mu, device="cpu"
    )
    res = sim.run(rounds)
    params = program.init(torch.Generator().manual_seed(0))
    spec = tree_spec(params)
    p = tree_ravel(params)[0].detach()
    opt = sgd(lr=lr, momentum=mu)
    state = opt.init(p)
    x, y = torch.as_tensor(shard.x), torch.as_tensor(shard.y)
    for step in range(rounds):
        p.requires_grad_(True)
        (grad,) = torch.autograd.grad(program.loss(tree_unravel(spec, p), x, y), p)
        p, state = opt.update(p.detach(), grad, state, step)
    params = tree_unravel(spec, p)
    np.testing.assert_allclose(flat(res.final_params), flat(params), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("option", ["model"])
def test_stream_unported_options_raise(scenarios, spec, option):
    """The lazy token population of the MoE program (``model="moe"``, once
    queued as Queue 1 item 10b) is the reference's: its source shards,
    test set, assignment and payload size, and one streaming round on it
    against the reference's (accuracy 1e-6, parameters 1e-4, traffic
    exact)."""
    kw = dict(lazy=True, n_eus=M, n_edges=N_EDGES, seed=SEED, n_test_per_class=16, lm_seq_len=16, lm_vocab=64)
    ref = ref_build("heartbeat", **{option: "moe"}, **kw)
    sc = build_scenario("heartbeat", **{option: "moe"}, **kw, device="cpu")
    assert sc.name == ref.name == "lm-stream-moe" and sc.model_bits == ref.model_bits
    assert sc.edge_of.tobytes() == ref.edge_of.tobytes()
    for got, want in [(sc.test, ref.test)] + [(sc.source.shard(c), ref.source.shard(c)) for c in (0, M - 1)]:
        assert got.x.tobytes() == want.x.tobytes() and got.y.tobytes() == want.y.tobytes()
    cohort = dict(size=8, seed=4)
    got = sc.simulate(CohortSpec(**cohort), cloud_rounds=1, schedule=SCHEDULE, seed=0, device="cpu")
    want = ref.simulate(ref_sampling.CohortSpec(**cohort), cloud_rounds=1, schedule=REF_SCHEDULE, seed=0)
    check_run(want, got, param_tol=1e-4)


def test_stream_simulate_records_telemetry(scenarios, spec):
    """``telemetry=True`` on the lazy scenario (ported in place of its
    refusal): the page gauges and one record per cloud round;
    ``tests/test_torch_telemetry.py`` holds them to the JAX package."""
    _, sc = scenarios
    res = sc.simulate(spec, cloud_rounds=1, telemetry=True, device="cpu")
    tel = res.telemetry
    assert [r["engine"] for r in tel.rounds] == ["sync-stream"]
    assert tel.metrics.gauges["page_misses"] > 0 and tel.metrics.gauges["participating"] == spec.size


# -- the reference's refusals, with the reference's error types ---------------
def _refusals(ref_sc, sc, materialized):
    ref_clients, clients, lam = materialized
    lat = np.full((M, N_EDGES), 0.05)
    kw = dict(cohort=CohortSpec(size=4), upp=0.5)
    ref_kw = dict(cohort=ref_sampling.CohortSpec(size=4), upp=0.5)
    return {
        "cohort-upp-simulator": (
            lambda: RefHFLSimulation(ref_clients, lam, ref_clients[0].program, ref_sc.test, **ref_kw),
            lambda: HFLSimulation(clients, lam, sc.program, sc.test, device="cpu", **kw),
        ),
        "cohort-upp-sync": (
            lambda: RefBatchedSyncEngine(ref_clients, lam, ref_clients[0].program, ref_sc.test, **ref_kw),
            lambda: BatchedSyncEngine(clients, lam, sc.program, sc.test, device="cpu", **kw),
        ),
        "cohort-upp-async": (
            lambda: RefAsyncHFLEngine(ref_clients, lam, ref_clients[0].program, ref_sc.test, lat, **ref_kw),
            lambda: AsyncHFLEngine(clients, lam, sc.program, sc.test, latency=lat, device="cpu", **kw),
        ),
        "lazy-without-n_eus": (
            lambda: ref_build("heartbeat", lazy=True),
            lambda: build_scenario("heartbeat", lazy=True, device="cpu"),
        ),
        "n_eus-without-lazy": (
            lambda: ref_build("heartbeat", n_eus=M),
            lambda: build_scenario("heartbeat", n_eus=M, device="cpu"),
        ),
        "n_edges-without-lazy": (
            lambda: ref_build("heartbeat", n_edges=N_EDGES),
            lambda: build_scenario("heartbeat", n_edges=N_EDGES, device="cpu"),
        ),
        "lazy-with-faults": (
            lambda: ref_build("heartbeat", lazy=True, n_eus=M, faults=object()),
            lambda: build_scenario("heartbeat", lazy=True, n_eus=M, faults=object(), device="cpu"),
        ),
        "lazy-with-hparams": (
            lambda: ref_build("heartbeat", lazy=True, n_eus=M, hparams=[{}] * M),
            lambda: build_scenario("heartbeat", lazy=True, n_eus=M, hparams=[{}] * M, device="cpu"),
        ),
        "stream-non-cohortspec": (
            lambda: RefStreamSyncEngine(ref_sc.source, ref_sc.edge_of, ref_sc.program, ref_sc.test, cohort=24),
            lambda: StreamSyncEngine(sc.source, sc.edge_of, sc.program, sc.test, cohort=24, device="cpu"),
        ),
        "assignment-matrix-over-16384": (
            lambda: ref_build("heartbeat", lazy=True, n_eus=16_385, n_test_per_class=1).assignment_matrix(),
            lambda: build_scenario("heartbeat", lazy=True, n_eus=16_385, n_test_per_class=1, device="cpu")
            .assignment_matrix(),
        ),
    }


REFUSALS = [
    "cohort-upp-simulator", "cohort-upp-sync", "cohort-upp-async", "lazy-without-n_eus", "n_eus-without-lazy",
    "n_edges-without-lazy", "lazy-with-faults", "lazy-with-hparams", "stream-non-cohortspec",
    "assignment-matrix-over-16384",
]


@pytest.mark.parametrize("case", REFUSALS)
def test_refuses_what_the_reference_refuses(scenarios, materialized, case):
    """Each refusal of the reference raises in the port too, with the same
    error type (``ValueError`` throughout)."""
    ref, sc = scenarios
    want_fn, got_fn = _refusals(ref, sc, materialized)[case]
    with pytest.raises(ValueError) as want:
        want_fn()
    with pytest.raises(ValueError) as got:
        got_fn()
    assert type(got.value) is type(want.value)
