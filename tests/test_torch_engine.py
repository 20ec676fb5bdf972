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
    res = sc.simulate(lam, cloud_rounds=2, schedule=HFLSchedule(2, 2), seed=0, device="cpu")
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
    res = sc.simulate(asn, cloud_rounds=1, seed=5, device="cpu")
    _check_trajectory(ref_res, res, len(sc.test), acc_tol=1e-6, param_tol=5e-3)


def test_partial_participation_and_wall_clock(pair, lam):
    ref, sc = pair
    sc = dataclasses.replace(sc, cost=ref.cost)  # the reference's latencies
    ref_res = ref.simulate(lam, cloud_rounds=2, seed=3, upp=0.6, engine="sync", wall_clock=True)
    res = sc.simulate(lam, cloud_rounds=2, seed=3, upp=0.6, wall_clock=True, device="cpu")
    _check_trajectory(ref_res, res, len(sc.test), acc_tol=1e-6, param_tol=5e-3)
    assert res.wall_seconds == pytest.approx(ref_res.wall_seconds, rel=1e-5)


@pytest.mark.parametrize(
    "kw",
    [
        {"engine": "reference"},
        {"engine": "async"},
        {"pipeline": "host"},
        {"pipeline": "mesh"},
        {"mesh": 4},
        {"compression": object()},
        {"faults": object()},
        {"telemetry": True},
        {"cohort": object()},
        {"serve": object()},
        {"distill": object()},
        {"track_divergence": True},
        {"server_momentum": 0.9},
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_unported_options_raise(pair, lam, kw):
    _, sc = pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sc.simulate(lam, cloud_rounds=1, device="cpu", **kw)


@pytest.mark.parametrize(
    "kw", [{"model": "mlp"}, {"fedsgd": True}, {"lazy": True}, {"model_mix": {"cnn": 18}}],
    ids=lambda kw: next(iter(kw)),
)
def test_unported_scenarios_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_scenario("heartbeat", scale=0.02, device="cpu", **kw)


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
