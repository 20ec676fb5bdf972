"""The readable simulator, the centralized baseline and the host pipeline:
the port against the JAX package on the same inputs, and the port's
engines against the port's simulator."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.hfl import HFLSchedule as RefSchedule  # noqa: E402
from repro.core.hfl import cloud_aggregate as ref_cloud_aggregate  # noqa: E402
from repro.core.hfl import weight_divergence as ref_weight_divergence  # noqa: E402
from repro.utils import tree as ref_tree  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.hfl import HFLSchedule, cloud_aggregate, weight_divergence  # noqa: E402
from repro_torch.engine import make_job, run_cohorts  # noqa: E402
from repro_torch.engine.flatten import FlatPack  # noqa: E402
from repro_torch.federated import HFLSimulation, Scenario, build_scenario  # noqa: E402
from repro_torch.utils import tree  # noqa: E402
from torch_parity import ReferencePopulation, check_run, flat, ref_flat, reference_inits  # noqa: E402

KW = dict(scale=0.02, seed=0, n_test_per_class=20)


@pytest.fixture(scope="module")
def pair():
    """A port heartbeat scenario and the same population in the reference
    package, the port's programs starting from the reference's initial
    parameters."""
    sc = build_scenario("heartbeat", device="cpu", **KW)
    with reference_inits():
        yield ReferencePopulation(sc), sc


def _assignment(sc, kind):
    if kind == "sca":
        return sc.assign("eara-sca", device="cpu").lam
    m, n = len(sc.clients), sc.n_edges  # half the EUs dual-homed
    asn = np.zeros((m, n))
    asn[np.arange(m), np.arange(m) % n] = 1.0
    asn[: m // 2, (np.arange(m // 2) + 1) % n] = 1.0
    return asn


# (assignment, upp, cloud rounds, seed); the TRACKED ones track divergence
CASES = {
    "sca-upp1.0": ("sca", 1.0, 1, 0),
    "sca-upp0.6": ("sca", 0.6, 1, 3),
    "dca-upp1.0": ("dca", 1.0, 1, 5),
    "dca-upp0.6": ("dca", 0.6, 1, 7),
}
TRACKED = ("sca-upp1.0", "dca-upp1.0")


def _run_kw(case):
    kind, upp, rounds, seed = CASES[case]
    return dict(cloud_rounds=rounds, seed=seed, upp=upp, track_divergence=case in TRACKED)


@pytest.fixture(scope="module")
def sim_runs(pair):
    """Each case run once by the port's readable simulator and once by the
    reference's, with its assignment."""
    ref, sc = pair
    out = {}
    for case, (kind, *_) in CASES.items():
        lam = _assignment(sc, kind)
        kw = _run_kw(case)
        rounds = kw.pop("cloud_rounds")
        out[case] = (lam, sc.simulate(lam, rounds, device="cpu", **kw), ref.simulate(lam, rounds, **kw))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_readable_simulator_matches_reference(sim_runs, case):
    """``engine="reference"`` (the default) against the reference's
    ``HFLSimulation``: accuracy 1e-6, mean loss 1e-5, parameters 5e-3, and
    the accountant's totals equal."""
    _, res, want = sim_runs[case]
    check_run(want, res)


@pytest.mark.parametrize("case", TRACKED)
def test_track_divergence_matches_reference(sim_runs, case):
    """The virtual centralized model's distance (eq. 17), stepped from the
    engine RNG after each cloud reduce: within 1e-2 relative of the
    reference simulator's, every round (and 0 where not tracked)."""
    _, res, want = sim_runs[case]
    assert [m.divergence for m in res.history] == pytest.approx([m.divergence for m in want.history], rel=1e-2)
    assert all(m.divergence > 0 for m in res.history)
    assert all(m.divergence == 0 for c in CASES if c not in TRACKED for m in sim_runs[c][1].history)


@pytest.mark.parametrize(
    "case,pipeline",
    [("sca-upp1.0", "device"), ("dca-upp0.6", "device"), ("sca-upp0.6", "host"), ("dca-upp1.0", "host")],
)
def test_sync_engine_matches_readable_simulator(pair, sim_runs, case, pipeline):
    """The port's batched engine, both pipelines, against the port's own
    simulator: accuracy 1e-6, parameters 5e-3 (the tolerances the reference
    holds its engines to), accounting equal, and (where tracked) the
    divergence, whose batches are drawn at the same point of the RNG
    stream, within 1e-2 relative."""
    _, sc = pair
    lam, want, _ = sim_runs[case]
    res = sc.simulate(lam, engine="sync", pipeline=pipeline, device="cpu", **_run_kw(case))
    check_run(want, res, loss_tol=5e-3, flat_want=flat)
    assert [m.divergence for m in res.history] == pytest.approx([m.divergence for m in want.history], rel=1e-2)


@pytest.mark.parametrize(
    "option,value",
    [("serve", object())],
)
def test_readable_simulator_refuses_unported_options(pair, option, value):
    """A ``serve`` that is not a ``TrafficSpec`` raises the reference's
    ``TypeError`` before the readable simulator is built."""
    _, sc = pair
    with pytest.raises(TypeError, match="TrafficSpec"):
        sc.simulate(sc.assign("dba", device="cpu").lam, 1, engine="reference", device="cpu", **{option: value})


def test_readable_simulator_records_telemetry(pair, tmp_path):
    """``telemetry=`` on ``HFLSimulation`` (ported in place of its
    refusal): the reference's spans and one record per cloud round, written
    to a directory; ``tests/test_torch_telemetry.py`` holds them to the JAX
    package."""
    _, sc = pair
    out = tmp_path / "sim"
    sim = HFLSimulation(sc.clients, sc.assign("dba", device="cpu").lam, sc.program, sc.test, device="cpu",
                        telemetry=str(out))
    res = sim.run(1)
    assert res.telemetry is sim.tel and [r["engine"] for r in res.telemetry.rounds] == ["reference"]
    assert {s.name for s in res.telemetry.tracer.spans} == {
        "assignment", "local_train", "edge_aggregate", "cloud_reduce", "eval", "cloud_round"
    }
    assert res.telemetry.flush()["rounds"] == out / "rounds.jsonl"


def test_simulate_defaults_to_the_readable_simulator():
    assert inspect.signature(Scenario.simulate).parameters["engine"].default == "reference"


def test_readable_simulator_two_epochs_two_edge_rounds(pair):
    """HFLSchedule(2, 2) under partial participation: parameters within
    5e-3 of the reference's simulator; accuracy within two test samples
    (the known near-tie difference of the sync engine's two-epoch test
    applies here too)."""
    ref, sc = pair
    lam = _assignment(sc, "sca")
    want = ref.simulate(lam, 1, schedule=RefSchedule(2, 2), upp=0.6, seed=2)
    sim = HFLSimulation(sc.clients, lam, sc.program, sc.test, schedule=HFLSchedule(2, 2), upp=0.6, seed=2, device="cpu")
    res = sim.run(1)
    check_run(want, res, acc_tol=2.0 / len(sc.test) + 1e-6, loss_tol=5e-3)


def test_centralized_matches_reference(pair):
    """``Scenario.centralized``: every shard pooled, batch 10 x edges."""
    ref, sc = pair
    want = ref.centralized(2)
    got = sc.centralized(2, device="cpu")
    assert [m.cloud_round for m in got] == [1, 2]
    for mw, mg in zip(want, got):
        assert mg.test_acc == pytest.approx(mw.test_acc, abs=1e-6)
        assert mg.mean_local_loss == pytest.approx(mw.mean_local_loss, abs=1e-5)


@pytest.mark.parametrize("cid", [0, 5, 13])  # 8, 4 and 64 steps
def test_local_update_matches_reference(pair, cid):
    """``FLClient.local_update`` from the same start on the same RNG, one
    epoch: parameters within 1e-5, the loss, and the RNG left in the same
    state."""
    ref, sc = pair
    start = ref.program.init(jax.random.PRNGKey(0))
    rng_ref, rng = np.random.default_rng(11), np.random.default_rng(11)
    want, want_loss = ref.clients[cid].local_update(start, rng_ref, epochs=1)
    got, loss = sc.clients[cid].local_update(params_from_numpy(jax.tree.map(np.asarray, start)), rng, epochs=1)
    np.testing.assert_allclose(flat(got), ref_flat(want), atol=1e-5, rtol=0)
    assert loss == pytest.approx(want_loss, abs=1e-5)
    assert rng.random() == rng_ref.random()


def test_run_cohorts_matches_local_update(pair):
    """The host pipeline's cohort training (the library convolution mapped
    over the clients, ``impl="xla"``) against each client's own
    ``local_update`` on the same draws: rows and losses within 1e-5, an
    empty shard passed through, rows gathered in any order."""
    from repro_torch.data.synthetic_health import Dataset
    from repro_torch.federated import FLClient

    _, sc = pair
    start = sc.program.init(torch.Generator().manual_seed(1))
    pack = FlatPack(start)
    row = pack.ravel(start)
    empty = sc.clients[0].shard.subset(np.arange(0))
    clients = [sc.clients[i] for i in (1, 3, 4, 8)] + [FLClient(18, Dataset(empty.x, empty.y, 5), sc.program)]
    jobs = [make_job(c, row, np.random.default_rng(c.cid), epochs=1) for c in clients]
    got = run_cohorts(jobs, sc.program, pack, impl="xla")
    for c in clients:
        want, loss = c.local_update(start, np.random.default_rng(c.cid), epochs=1)
        np.testing.assert_allclose(got.row(c.cid).numpy(), flat(want), atol=1e-5, rtol=0)
        assert got.loss[c.cid] == pytest.approx(loss, abs=1e-5)
    assert torch.equal(got.row(18), row)
    ids = [8, 18, 1]
    assert torch.equal(got.gather(ids), torch.stack([got.row(i) for i in ids]))


def test_run_cohorts_refuses_mixed_programs(pair):
    """Jobs of two programs never share a matrix: each program's rows land
    in a block of its own width, and a single-matrix view or a gather across
    the blocks raises ``ValueError``."""
    from repro_torch.engine import pack_for
    from repro_torch.federated import FLClient, MLPProgram

    _, sc = pair
    other = FLClient(99, sc.clients[0].shard, MLPProgram())
    pack = FlatPack(sc.program.init(torch.Generator().manual_seed(0)))
    jobs = [make_job(sc.clients[0], torch.zeros(pack.dim), np.random.default_rng(0), 1),
            make_job(other, torch.zeros(pack_for(other.program).dim), np.random.default_rng(0), 1)]
    got = run_cohorts(jobs, sc.program, pack)
    assert [b.shape for b in got.blocks] == [(1, pack.dim), (1, pack_for(other.program).dim)]
    with pytest.raises(ValueError, match="program blocks"):
        got.matrix
    with pytest.raises(ValueError, match="span program blocks"):
        got.gather([0, 99])


def _trees(seed, n):
    rng = np.random.default_rng(seed)
    return [
        {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)}, "b": rng.standard_normal(7).astype(np.float32)}
        for _ in range(n)
    ]


@pytest.mark.parametrize("weights", [[1.0, 2.0, 3.0], [17.0, 0.0, 4.0], [1e-3, 1e-3, 5e3]])
def test_tree_fedavg_and_divergence_match_reference(weights):
    """``tree_weighted_mean`` through ``cloud_aggregate`` (float64 sizes to
    float32, normalized with no clamp, contracted in float32),
    ``tree_l2_norm`` through ``weight_divergence``, and the elementwise
    helpers, against the reference's on the same trees."""
    trees = _trees(4, 3)
    jt = [jax.tree.map(jnp.asarray, t) for t in trees]
    tt = [params_from_numpy(t) for t in trees]
    got, want = cloud_aggregate(tt, weights), ref_cloud_aggregate(jt, weights)
    np.testing.assert_allclose(flat(got), ref_flat(want), atol=1e-6, rtol=1e-6)
    assert weight_divergence(tt[0], tt[1]) == pytest.approx(ref_weight_divergence(jt[0], jt[1]), rel=1e-6)
    for fn, ref_fn in ((tree.tree_add, ref_tree.tree_add), (tree.tree_sub, ref_tree.tree_sub)):
        np.testing.assert_array_equal(flat(fn(tt[0], tt[2])), ref_flat(ref_fn(jt[0], jt[2])))
    np.testing.assert_array_equal(flat(tree.tree_scale(tt[1], 0.25)), ref_flat(ref_tree.tree_scale(jt[1], 0.25)))
    assert float(tree.tree_l2_norm(tt[2])) == pytest.approx(float(ref_tree.tree_l2_norm(jt[2])), rel=1e-6)
