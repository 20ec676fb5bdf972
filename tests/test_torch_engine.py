"""The slice as a whole: the port's sync engine, cost model and EARA
assignment against the reference's, given the reference's λ, initial
parameters and cost matrices."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.assignment import dba_assignment as ref_dba  # noqa: E402
from repro.core.assignment import eara as ref_eara  # noqa: E402
from repro.core.assignment import random_assignment as ref_random  # noqa: E402
from repro.core.hfl import HFLSchedule as RefSchedule  # noqa: E402
from repro.core.lp import solve_lp_eg as ref_solve_lp_eg  # noqa: E402
from repro.federated import build_scenario as ref_build  # noqa: E402
from repro.utils.tree import tree_ravel as ref_tree_ravel  # noqa: E402
from repro.wireless.channel import build_cost_matrices as ref_cost_matrices  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    HFLSchedule,
    dba_assignment,
    eara,
    random_assignment,
    solve_lp_eg,
    solve_lp_scipy,
)
from repro_torch.engine import sync_sim  # noqa: E402
from repro_torch.engine.flatten import FlatPack  # noqa: E402
from repro_torch.federated import build_scenario  # noqa: E402
from repro_torch.federated.programs import CNNProgram  # noqa: E402
from repro_torch.wireless import build_cost_matrices  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    """Reference and port scenarios on the same data; the port's program
    starts from the reference's initial parameters (``jax.random`` draws
    cannot be repeated in torch)."""
    kw = dict(scale=0.02, seed=0, n_test_per_class=20)
    ref = ref_build("heartbeat", **kw)
    sc = build_scenario("heartbeat", device="cpu", **kw)

    def ref_init(self, generator):
        # the engine seeds its generator with the run's seed, as the
        # reference seeds its PRNGKey
        key = jax.random.PRNGKey(generator.initial_seed())
        return params_from_numpy(jax.tree.map(np.asarray, ref.program.init(key)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CNNProgram, "init", ref_init)
        yield ref, sc


@pytest.fixture(scope="module")
def lam(pair):
    return pair[0].assign("eara-sca").lam


def _flat(params) -> np.ndarray:
    return FlatPack(params).ravel(params).numpy()


def _check_trajectory(ref_res, res, n_test, acc_tol, param_tol):
    assert len(res.history) == len(ref_res.history)
    for mr, mt in zip(ref_res.history, res.history):
        assert mt.cloud_round == mr.cloud_round
        assert mt.test_acc == pytest.approx(mr.test_acc, abs=acc_tol)
        assert mt.mean_local_loss == pytest.approx(mr.mean_local_loss, abs=5e-3)
    assert res.accountant.edge_rounds == ref_res.accountant.edge_rounds
    assert res.accountant.cloud_rounds == ref_res.accountant.cloud_rounds
    assert res.accountant.eu_traffic_bits() == ref_res.accountant.eu_traffic_bits()
    assert res.accountant.edge_cloud_bits == ref_res.accountant.edge_cloud_bits
    ref_row = np.asarray(ref_tree_ravel(ref_res.final_params)[0])
    np.testing.assert_allclose(_flat(res.final_params), ref_row, atol=param_tol, rtol=0)


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_sync_engine_matches_reference_one_epoch(pair, lam, backend):
    """HFLSchedule(1, 1): one local epoch per edge round.  Accuracy within
    1e-6, parameters within 5e-3 (the tolerances the reference's engines
    hold each other to; this trajectory actually agrees to ~1e-6)."""
    ref, sc = pair
    ref_res = ref.simulate(lam, cloud_rounds=2, seed=0, engine="sync")
    res = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", pipeline="device",
                      backend=backend, device="cpu")
    _check_trajectory(ref_res, res, len(sc.test), acc_tol=1e-6, param_tol=5e-3)


def test_sync_engine_matches_reference_two_epochs(pair, lam):
    """HFLSchedule(2, 2): two local epochs per edge round, two edge rounds
    per cloud round.

    Each local epoch restarts Adam, whose first step moves a parameter by
    lr * g / (|g| + 1e-8).  A few gradient components of the trained model
    are ~1e-9 and come out of float32 cancellation, so the two frameworks'
    matrix-product summation orders give them relative differences of
    several percent, and each restart turns that into parameter moves of
    ~1e-3 (the reference's own engines differ by 1.5e-3 here).  Two test
    predictions of 100 sit on near-ties (top-two logit margins 0.05 and
    0.2, against a median of 5) and flip in round 2, so accuracy is held
    to two test samples, and every prediction whose margin in the
    reference's final model exceeds 0.5 must agree; parameters, losses and
    accounting keep the one-epoch tolerances.
    """
    ref, sc = pair
    ref_res = ref.simulate(lam, cloud_rounds=2, schedule=RefSchedule(2, 2), seed=0, engine="sync")
    res = sc.simulate(lam, cloud_rounds=2, schedule=HFLSchedule(2, 2), seed=0, engine="sync", device="cpu")
    n = len(sc.test)
    _check_trajectory(ref_res, res, n, acc_tol=2.0 / n + 1e-6, param_tol=5e-3)
    want = np.asarray(ref.program.apply(ref_res.final_params, jax.numpy.asarray(sc.test.x)))
    got = sc.program.apply(res.final_params, torch.tensor(sc.test.x)).numpy()
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 0.5
    np.testing.assert_array_equal(got.argmax(1)[clear], want.argmax(1)[clear])


def test_sync_engine_dual_connectivity(pair):
    """Half the EUs dual-homed: the DCA start rows go through the segment
    aggregation with segments = clients."""
    ref, sc = pair
    m, n = len(sc.clients), sc.n_edges
    asn = np.zeros((m, n))
    asn[np.arange(m), np.arange(m) % n] = 1.0
    asn[: m // 2, (np.arange(m // 2) + 1) % n] = 1.0
    ref_res = ref.simulate(asn, cloud_rounds=1, seed=5, engine="sync")
    res = sc.simulate(asn, cloud_rounds=1, seed=5, engine="sync", device="cpu")
    _check_trajectory(ref_res, res, len(sc.test), acc_tol=1e-6, param_tol=5e-3)


def test_partial_participation_and_wall_clock(pair, lam):
    ref, sc = pair
    sc = dataclasses.replace(sc, cost=ref.cost)  # the reference's latencies
    ref_res = ref.simulate(lam, cloud_rounds=2, seed=3, upp=0.6, engine="sync", wall_clock=True)
    res = sc.simulate(lam, cloud_rounds=2, seed=3, upp=0.6, engine="sync", wall_clock=True, device="cpu")
    _check_trajectory(ref_res, res, len(sc.test), acc_tol=1e-6, param_tol=5e-3)
    assert res.wall_seconds == pytest.approx(ref_res.wall_seconds, rel=1e-5)


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_cloud_weights_go_to_the_device_once_per_run(pair, lam, backend, monkeypatch):
    """Every cloud round's ``flat_mean`` receives the same fp32 tensor on
    the engine's device (uploaded once per run, so no round copies from the
    host), and the history and final parameters equal those of a run whose
    reduce gets the weights as a numpy array, as it did before."""
    _, sc = pair
    real = sync_sim.flat_mean
    seen = []

    def spy(updates, weights, **kw):
        seen.append(weights)
        return real(updates, weights, **kw)

    monkeypatch.setattr(sync_sim, "flat_mean", spy)
    res = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", backend=backend, device="cpu")
    assert len(seen) == 2 and seen[0] is seen[1]
    assert isinstance(seen[0], torch.Tensor) and seen[0].dtype == torch.float32
    assert seen[0].device == torch.device("cpu")
    monkeypatch.setattr(sync_sim, "flat_mean", lambda u, w, **kw: real(u, w.numpy(), **kw))
    host = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", backend=backend, device="cpu")
    assert [(h.test_acc, h.mean_local_loss) for h in res.history] == [
        (h.test_acc, h.mean_local_loss) for h in host.history
    ]
    np.testing.assert_array_equal(_flat(res.final_params), _flat(host.final_params))


@pytest.mark.parametrize(
    "kw,raises,match",
    [
        ({"engine": "sync", "pipeline": "mesh"}, None, None),
        ({"engine": "sync", "mesh": 4}, ValueError, "n_devices"),
        ({"engine": "reference", "pipeline": "mesh", "mesh": 4}, None, None),
        ({"engine": "async", "pipeline": "mesh", "mesh": 4}, None, None),
        ({"serve": object()}, TypeError, "TrafficSpec"),
    ],
    ids=["pipeline", "mesh", "reference-ignores-mesh", "async-ignores-mesh", "serve"],
)
def test_unported_options_raise(pair, lam, kw, raises, match):
    """The mesh options, which only ``engine="sync"`` reads (as in the
    reference): ``pipeline="mesh"`` runs the mesh engine (one rank here)
    and sets ``comm_report``; ``mesh=4`` in a one-rank process raises the
    reference's ``ValueError`` (its ``edge_mesh`` bound).  The readable
    simulator and async ignore both.  A ``serve`` that is not a
    ``TrafficSpec`` raises the reference's ``TypeError``."""
    _, sc = pair
    if raises is None:
        res = sc.simulate(lam, cloud_rounds=1, device="cpu", **kw)
        assert len(res.history) == 1
        assert (res.comm_report is not None) == (kw.get("engine") == "sync")
        return
    with pytest.raises(raises, match=match):
        sc.simulate(lam, cloud_rounds=1, device="cpu", **kw)


def test_sync_engine_pipeline_must_be_known(pair, lam):
    """As the reference: ``BatchedSyncEngine`` takes the pipelines it has
    and raises ``ValueError`` for any other, "mesh" included."""
    _, sc = pair
    for pipeline in ("mesh", "bogus"):
        with pytest.raises(ValueError, match="pipeline must be one of"):
            sync_sim.BatchedSyncEngine(sc.clients, lam, sc.program, sc.test, pipeline=pipeline, device="cpu")


@pytest.mark.parametrize("pipeline", ["device", "host"])
def test_sync_engine_records_telemetry(pair, lam, pipeline):
    """``telemetry=True`` on the sync engine (ported in place of its
    refusal): the run's ``Telemetry`` on the result, one record per cloud
    round and the reference's spans; ``tests/test_torch_telemetry.py`` holds
    them to the JAX package."""
    _, sc = pair
    res = sc.simulate(lam, cloud_rounds=1, engine="sync", pipeline=pipeline, device="cpu", telemetry=True)
    tel = res.telemetry
    assert [r["round"] for r in tel.rounds] == [1] and tel.rounds[0]["engine"] == f"sync-{pipeline}"
    assert {"assignment", "cohort_epoch", "edge_aggregate", "cloud_reduce", "eval", "cloud_round"} <= {
        s.name for s in tel.tracer.spans
    }


def test_faults_must_be_a_fault_spec(pair, lam):
    """As in the reference: ``faults=`` takes a ``FaultSpec`` (or None /
    False), anything else raises ``TypeError``."""
    _, sc = pair
    with pytest.raises(TypeError, match="FaultSpec"):
        sc.simulate(lam, cloud_rounds=1, device="cpu", faults=object())


@pytest.mark.parametrize(
    "kw,raises",
    [({"model_mix": {"lm": 8, "moe": 4}}, True), ({"model_mix": {"lm": 12}}, False)],
    ids=["model_mix", "model_mix-lm"],
)
def test_unported_scenarios_raise(kw, raises):
    """A ``model_mix`` naming "moe" (ported from ROADMAP.md Queue 1 item
    10b) builds the mixed token population; a mix of "lm" alone builds the
    homogeneous one.  ``raises`` marks the case that once raised."""
    sc = build_scenario("heartbeat", scale=0.02, device="cpu", **kw)
    assert len(sc.clients) == 12 and sc.is_hetero == raises
    assert sc.name == ("mix(lm+moe)" if raises else "lm")
    assert (sc.public is not None) == raises


# -- one-off host work: cost model and assignment ------------------------------
@pytest.fixture(scope="module", params=["heartbeat", "seizure"])
def ref_instance(request):
    return ref_build(request.param, scale=0.02, seed=0, n_test_per_class=20)


def test_cost_matrices_match_reference(ref_instance):
    r = ref_instance
    cost = build_cost_matrices(r.topo, r.model_bits, r.wp, device="cpu")
    want = ref_cost_matrices(r.topo, r.model_bits, r.wp)
    for field in ("latency", "energy", "rate", "gain", "compute_time"):
        np.testing.assert_allclose(getattr(cost, field), getattr(want, field), rtol=1e-5)
    np.testing.assert_array_equal(cost.feasible, want.feasible)


def test_eara_and_dba_match_reference(ref_instance):
    """On the reference's class counts and cost matrices: the LP solution
    within 1e-3 of the reference solver's, and the rounded λ equal."""
    r = ref_instance
    want_frac = np.asarray(ref_solve_lp_eg(np.asarray(r.class_counts, np.float32), r.cost.feasible))
    frac = solve_lp_eg(r.class_counts, r.cost.feasible, device="cpu").numpy()
    np.testing.assert_allclose(frac, want_frac, atol=1e-3)
    np.testing.assert_allclose(frac.sum(axis=1), 1.0, atol=1e-5)
    exact = solve_lp_scipy(r.class_counts, r.cost.feasible)
    assert exact.shape == frac.shape
    for mode, refine in (("sca", False), ("dca", False), ("sca", True)):
        args = (r.class_counts, r.cost, r.wp, r.model_bits, r.topo.tx_power_max)
        want = ref_eara(*args, mode=mode, refine=refine)
        got = eara(*args, mode=mode, refine=refine, device="cpu")
        np.testing.assert_array_equal(got.lam, want.lam)
        np.testing.assert_allclose(got.lam_frac, want.lam_frac, atol=1e-3)
        assert got.kld_total == pytest.approx(want.kld_total, abs=1e-5)
        assert got.objective_l1 == pytest.approx(want.objective_l1, rel=1e-5)
        np.testing.assert_array_equal(got.served, want.served)
        np.testing.assert_allclose(got.bandwidth, want.bandwidth, rtol=1e-6)
    for got, want in (
        (dba_assignment(r.class_counts, r.topo.dist), ref_dba(r.class_counts, r.topo.dist)),
        (random_assignment(r.class_counts, 4, seed=2), ref_random(r.class_counts, 4, seed=2)),
    ):
        np.testing.assert_array_equal(got.lam, want.lam)
        assert got.kld_total == pytest.approx(want.kld_total, abs=1e-5)
        assert got.objective_l1 == pytest.approx(want.objective_l1, rel=1e-5)
