"""The asynchronous engine: the port's ``AsyncHFLEngine`` against the JAX
package's on the same shards, initial parameters and latency array, its
event queue (copied from the reference), and its behaviour with a
straggler."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.hfl import HFLSchedule as RefSchedule  # noqa: E402
from repro_torch.core import CompressionSpec, HFLSchedule  # noqa: E402
from repro_torch.engine import AsyncHFLEngine, DeviceShardStore, EventQueue, async_sim, make_job, run_cohorts  # noqa: E402
from repro_torch.engine.flatten import FlatPack  # noqa: E402
from repro_torch.federated import CohortSpec, build_scenario  # noqa: E402
from torch_parity import ReferencePopulation, check_run, reference_inits  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# local epochs capped at 4 steps: two step buckets, so the reference
# compiles few cohort shapes
CAPPED = [{"max_steps": 4}] * 18


@pytest.fixture(scope="module")
def pair():
    """A port heartbeat scenario whose cost model is the reference's (so
    both engines run on one latency array: float32 latencies from two
    libraries could order events differently), and the same population in
    the reference package."""
    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu", hparams=CAPPED)
    with reference_inits():
        ref = ReferencePopulation(sc)
        yield ref, dataclasses.replace(sc, cost=ref.cost)


def _dual_homed(m, n):
    """Every EU on edge i % n, the first half also on edge (i + 1) % n."""
    asn = np.zeros((m, n))
    asn[np.arange(m), np.arange(m) % n] = 1.0
    half = np.arange(m // 2)
    asn[half, (half + 1) % n] = 1.0
    return asn


def test_event_queue_is_the_reference_file():
    assert (ROOT / "src/repro_torch/engine/events.py").read_bytes() == (ROOT / "src/repro/engine/events.py").read_bytes()
    q = EventQueue()
    for t, name in ((2.0, "b"), (1.0, "a"), (2.0, "c")):
        q.push(t, "upload", name=name)
    assert [q.pop().payload["name"] for _ in range(3)] == ["a", "b", "c"]  # ties by push order
    assert q.now == 2.0
    with pytest.raises(ValueError):
        q.push(1.5, "upload")


CASES = {
    # (assignment, quorum, staleness_decay, schedule, upp, compression)
    "sync-corner": ("sca", 1.0, 1.0, (1, 1), 1.0, None),
    "defaults": ("sca", 0.75, 0.5, (1, 2), 1.0, None),
    "dca-upp0.7": ("dca", 0.75, 0.5, (1, 2), 0.7, None),
    "topk": ("sca", 0.75, 0.5, (1, 2), 1.0, CompressionSpec("topk", fraction=0.05)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_async_engine_matches_reference(pair, case):
    """Two cloud rounds through ``Scenario.simulate(engine="async")``
    against the reference's engine: accuracy 1e-6, parameters 5e-3, the
    nine accountant totals, per-EU traffic, the simulated seconds of every
    round and ``wall_seconds`` exact."""
    ref, sc = pair
    kind, quorum, decay, sched, upp, compression = CASES[case]
    lam = sc.assign("eara-sca", device="cpu").lam if kind == "sca" else _dual_homed(len(sc.clients), sc.n_edges)
    kw = dict(quorum=quorum, staleness_decay=decay, upp=upp, seed=1, compression=compression)
    want = ref.simulate(lam, 2, engine="async", latency=ref.cost.latency, schedule=RefSchedule(*sched), **kw)
    got = sc.simulate(lam, 2, engine="async", schedule=HFLSchedule(*sched), device="cpu", **kw)
    check_run(want, got)
    assert got.wall_seconds == want.wall_seconds
    assert [h.sim_seconds for h in got.history] == [h.sim_seconds for h in want.history]


def test_async_counts_its_aggregates(pair):
    """The engine's own counts: one ``flat_mean`` per flush, DCA start and
    cloud reduce; the flush histogram sums to the flushes, and the weights
    go up once per flush plus once per run (the cloud weights)."""
    _, sc = pair
    lam = _dual_homed(len(sc.clients), sc.n_edges)
    eng = AsyncHFLEngine(sc.clients, lam, sc.program, sc.test, latency=sc.cost.latency,
                         schedule=HFLSchedule(1, 2), device="cpu")
    calls = []
    real = async_sim.flat_mean

    def flat_mean_spy(updates, weights, **kw):
        calls.append(updates.shape[0])
        return real(updates, weights, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(async_sim, "flat_mean", flat_mean_spy)
        res = eng.run(2)
    agg = eng.aggregates
    assert agg["cloud_reduce"] == 2 and agg["dca_start"] > 0
    assert len(calls) == sum(agg.values())
    assert sum(eng.flush_rows.values()) == agg["flush"] == res.accountant.edge_rounds
    flush_rows = sum(n * count for n, count in eng.flush_rows.items())
    assert sum(calls) == flush_rows + 2 * agg["dca_start"] + sc.n_edges * agg["cloud_reduce"]
    assert eng.weight_uploads == agg["flush"] + 1


def test_cohort_route_does_not_change_results(pair):
    """``run_cohorts`` with the device store and with host stacking train on
    the same samples: identical rows and losses."""
    _, sc = pair
    params = sc.program.init(torch.Generator().manual_seed(0))
    pack = FlatPack(params)
    start = pack.ravel(params)

    def jobs():
        rng = np.random.default_rng(3)
        return [make_job(c, start, rng, epochs=2) for c in sc.clients]

    store = DeviceShardStore.build_if_economical(sc.clients, "cpu")
    assert store is not None
    a = run_cohorts(jobs(), sc.program, pack, store=store)
    b = run_cohorts(jobs(), sc.program, pack)
    assert a.index == b.index and a.loss == b.loss
    assert torch.equal(a.matrix, b.matrix)


def test_store_declines_skewed_shards(pair):
    """One shard 17x the mean: padding would cost more than the gather
    saves, so no store is built (and the engine stacks on the host)."""
    from repro_torch.data.synthetic_health import Dataset

    _, sc = pair
    big = dataclasses.replace(sc.clients[0], shard=Dataset(
        np.repeat(sc.clients[0].shard.x, 400, axis=0), np.repeat(sc.clients[0].shard.y, 400), 5))
    assert DeviceShardStore.build_if_economical([big] + sc.clients[1:], "cpu") is None
    assert DeviceShardStore.build_if_economical(sc.clients, "cpu") is not None


def test_async_straggler_does_not_block(pair):
    """One EU three orders of magnitude slower: quorum flushes close the
    edge rounds and the cloud round without waiting for it (the reference's
    ``tests/test_engine.py`` straggler test, on the port)."""
    _, sc = pair
    assignment = sc.assign("eara-sca", device="cpu").lam
    lat = np.full(sc.cost.latency.shape, 0.01)
    straggler = int(np.argmax(assignment.sum(1) > 0))
    lat[straggler, :] = 50.0
    eng = AsyncHFLEngine(sc.clients, assignment, sc.program, sc.test, latency=lat, schedule=HFLSchedule(1, 2),
                         seed=0, quorum=0.5, staleness_decay=0.5, device="cpu")
    res = eng.run(2)
    assert len(res.history) == 2
    assert res.wall_seconds < 50.0
    assert res.accountant.cloud_rounds == 2
    assert res.accountant.edge_rounds >= 2
    assert res.final_accuracy() > 1.0 / 5


def test_async_refuses_what_the_reference_refuses(pair):
    _, sc = pair
    lam = sc.assign("eara-sca", device="cpu").lam
    with pytest.raises(ValueError, match="track_divergence"):
        sc.simulate(lam, 1, engine="async", track_divergence=True, device="cpu")
    with pytest.raises(ValueError, match="quorum"):
        sc.simulate(lam, 1, engine="async", quorum=0.0, device="cpu")
    with pytest.raises(ValueError, match="upp=1.0"):
        AsyncHFLEngine(
            sc.clients, lam, sc.program, sc.test, latency=sc.cost.latency, cohort=CohortSpec(size=4), upp=0.5,
            device="cpu",
        )
