"""The fault layer: the port's ``FaultSpec`` / ``FaultState`` and
``repair_assignment`` against the JAX package's, schedule for schedule, and
the chaos runs of every engine against the reference's on the same inputs.

The engines' parity runs give both packages' ``FaultState`` the same cost
matrices (``torch_parity.reference_costs``): float32 from XLA and from
PyTorch may differ in the last bits, and an energy budget or a latency
deadline compared against them could flip.  The cost matrices' own
agreement is held apart, at rtol 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.assignment import repair_assignment as ref_repair_assignment  # noqa: E402
from repro.core.hfl import HFLSchedule as RefSchedule  # noqa: E402
from repro.faults import FaultSpec as RefFaultSpec  # noqa: E402
from repro_torch.core import HFLSchedule, repair_assignment  # noqa: E402
from repro_torch.faults import FaultSpec, FaultState  # noqa: E402
from repro_torch.federated import build_scenario  # noqa: E402
from torch_parity import ReferencePopulation, check_run, flat, reference_costs, reference_inits  # noqa: E402

# tests/test_faults.py's acceptance spec: >= 20% churn, lossy uplinks with
# retries, finite batteries, per-round re-fade with slow drift
CHAOS = dict(
    p_drop=0.25, p_rejoin=0.5, p_fail=0.2, max_retries=2, backoff_s=0.1,
    energy_uploads=6.0, refade_rounds=1, drift_rate=0.05,
)
# local epochs capped at 4 steps: two step buckets, so the reference
# compiles few cohort shapes
CAPPED = [{"max_steps": 4}] * 18


@pytest.fixture(scope="module")
def pair():
    """The heartbeat MLP population (the reference's fault tests run the
    MLP) whose cost model is the reference's, and the same population in
    the reference package."""
    sc = build_scenario("heartbeat", model="mlp", scale=0.02, seed=0, n_test_per_class=20, device="cpu",
                        hparams=CAPPED)
    with reference_inits():
        ref = ReferencePopulation(sc)
        yield ref, dataclasses.replace(sc, cost=ref.cost)


@pytest.fixture(scope="module")
def lam(pair):
    return pair[1].assign("eara-sca", device="cpu").lam


def _state(sc, spec) -> FaultState:
    return FaultState(spec, sc.topo, sc.wp, sc.model_bits, class_counts=sc.class_counts, device="cpu")


# -- FaultSpec ------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(p_drop=1.5), dict(p_rejoin=-0.1), dict(start_up=2.0), dict(p_fail=-1e-9), dict(max_retries=-1),
    dict(backoff_s=-0.5), dict(timeout_s=0.0), dict(energy_uploads=0.0), dict(energy_spread=1.0),
    dict(refade_rounds=-1), dict(drift_rate=-0.1),
], ids=lambda kw: next(iter(kw)))
def test_spec_validation_rejects(kw):
    with pytest.raises(ValueError) as got:
        FaultSpec(seed=0, **kw)
    with pytest.raises(ValueError) as want:
        RefFaultSpec(seed=0, **kw)
    assert str(got.value) == str(want.value)


def test_reassign_needs_class_counts(pair):
    _, sc = pair
    with pytest.raises(ValueError, match="class_counts"):
        FaultState(FaultSpec(reassign=True), sc.topo, sc.wp, sc.model_bits, device="cpu")


# -- keyed schedules, byte for byte ------------------------------------------------
SCHEDULE_SPECS = {
    "chaos-3": dict(seed=3, **CHAOS),
    "chaos-9": dict(seed=9, **CHAOS),
    "block-refade": dict(seed=2, refade_rounds=2, drift_rate=0.1, p_fail=0.5, start_up=0.7),
    "static-fade": dict(seed=5, refade_rounds=0, p_drop=0.4, p_fail=0.3, max_retries=4, timeout_s=0.6,
                        energy_uploads=2.0, energy_spread=0.5),
}


@pytest.mark.parametrize("name", list(SCHEDULE_SPECS))
def test_keyed_schedules_byte_equal(pair, name):
    """Availability, participation, fading, mid-round losses, energy
    budgets and retry cascades (given one latency array) come out of both
    packages byte-equal, round after round."""
    ref, sc = pair
    spec = FaultSpec(**SCHEDULE_SPECS[name])
    with reference_costs(ref):
        port = _state(sc, spec)
    want = ref.fault_state(spec)
    assert port.energy_budget.tobytes() == want.energy_budget.tobytes()
    latency = ref.cost.latency
    for b in range(1, 5):
        assert port.availability(b).tobytes() == want.availability(b).tobytes()
        assert port.fading(b).tobytes() == want.fading(b).tobytes()
        for er in (1, 2):
            assert port.failed_uploads(b, er).tobytes() == want.failed_uploads(b, er).tobytes()
        with reference_costs(ref):
            for i, j in ((0, 0), (3, 1), (7, 4), (0, 0)):  # a repeat draws a fresh dispatch
                got, exp = port.plan_upload(b, i, j, float(latency[i, j])), want.plan_upload(b, i, j, float(latency[i, j]))
                assert dataclasses.astuple(got) == dataclasses.astuple(exp)
            port.debit_round(b, port.participation(b), np.eye(18, 5))
        want.debit_round(b, want.participation(b), np.eye(18, 5))
        assert port.energy_remaining.tobytes() == want.energy_remaining.tobytes()
        assert port.participation(b).tobytes() == want.participation(b).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repair_assignment_equal(pair, seed):
    """Random drifted feasible sets over an assignment with dual-homed
    rows: the same repaired λ and changed rows."""
    _, sc = pair
    rng = np.random.default_rng(seed)
    m, n = sc.class_counts.shape[0], 5
    lam = np.zeros((m, n))
    lam[np.arange(m), rng.integers(0, n, m)] = 1.0
    lam[rng.integers(0, m, 4), rng.integers(0, n, 4)] = 1.0
    feasible = rng.random((m, n)) < 0.5
    feasible[rng.integers(0, m)] = False  # an EU with no feasible edge sits out
    got, got_changed = repair_assignment(lam, sc.class_counts, feasible)
    want, want_changed = ref_repair_assignment(lam, sc.class_counts, feasible)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_changed, want_changed)


def test_state_repair_and_costs_match_reference(pair, lam):
    """Under strong drift: ``FaultState.repair`` equal on the reference's
    cost matrices, and the port's own cost matrices within rtol 1e-5 of
    the reference's at every round, with the same feasible pairs."""
    ref, sc = pair
    spec = FaultSpec(seed=5, p_drop=0.0, refade_rounds=1, drift_rate=0.3, reassign=True)
    want = ref.fault_state(spec)
    own = _state(sc, spec)
    with reference_costs(ref):
        port = _state(sc, spec)
        for b in (1, 2, 3):
            got_lam, got_changed = port.repair(b, lam)
            want_lam, want_changed = want.repair(b, lam)
            np.testing.assert_array_equal(got_lam, want_lam)
            np.testing.assert_array_equal(got_changed, want_changed)
    for b in (1, 2, 3):
        for field in ("latency", "energy", "rate", "gain", "compute_time"):
            np.testing.assert_allclose(getattr(own.cost(b), field), getattr(want.cost(b), field), rtol=1e-5)
        np.testing.assert_array_equal(own.cost(b).feasible, want.cost(b).feasible)


# -- the engines under faults against the JAX package -------------------------------
ENGINES = {
    "reference": dict(engine="reference"),
    "sync-host": dict(engine="sync", pipeline="host"),
    "sync-device": dict(engine="sync", pipeline="device"),
    "async": dict(engine="async"),
}


def _pair_runs(pair, lam, spec, kw, rounds=2, wall_clock=False):
    ref, sc = pair
    ref_kw = dict(kw)
    if kw["engine"] == "async":
        ref_kw["latency"] = ref.cost.latency
    elif wall_clock:
        ref_kw["cost_latency"] = ref.cost.latency
    want = ref.simulate(lam, rounds, schedule=RefSchedule(1, 2), seed=0, faults=spec, **ref_kw)
    with reference_costs(ref):
        got = sc.simulate(lam, rounds, schedule=HFLSchedule(1, 2), seed=0, faults=spec, device="cpu",
                          wall_clock=wall_clock, **kw)
    return want, got


@pytest.mark.parametrize("engine", list(ENGINES))
def test_chaos_run_matches_reference(pair, lam, engine):
    """The chaos spec, two cloud rounds of two edge rounds: accuracy 1e-6,
    parameters 5e-3, the nine accountant totals and per-EU traffic exact;
    the simulated seconds of every round exact (the sync engines' straggler
    clock on the round's faded latency, the async engine's event clock).  The sync paths drop
    uploads, the async engine retries them."""
    spec = FaultSpec(seed=3, **CHAOS)
    want, got = _pair_runs(pair, lam, spec, ENGINES[engine], wall_clock=engine != "async")
    check_run(want, got)
    assert [h.sim_seconds for h in got.history] == [h.sim_seconds for h in want.history]
    assert got.history[-1].sim_seconds > 0
    totals = got.accountant.totals()
    assert totals["wasted_bits"] > 0
    if engine == "async":
        assert totals["retried_uploads"] > 0
        assert got.wall_seconds == want.wall_seconds
    else:
        assert totals["dropped_uploads"] > 0


@pytest.mark.parametrize("engine", ["sync-device", "sync-host", "async"])
def test_reassign_under_drift_matches_reference(pair, lam, engine):
    """Drift strong enough to invalidate memberships, with re-repair: the
    sync engine rebuilds its pair structure and uploads its cloud weights
    again; every engine still matches the reference."""
    spec = FaultSpec(seed=5, p_drop=0.0, refade_rounds=1, drift_rate=0.3, reassign=True)
    want, got = _pair_runs(pair, lam, spec, ENGINES[engine])
    check_run(want, got)


@pytest.mark.parametrize("engine", ["sync-device", "async"])
def test_total_upload_loss_keeps_the_global_model(pair, lam, engine):
    """Every upload lost: the sync paths aggregate nothing and keep the
    global model; the async engine's cascades abandon, its edges starve and
    the degraded drain still closes every round."""
    spec = FaultSpec(seed=1, p_drop=0.0, p_fail=1.0, max_retries=0, backoff_s=0.01)
    want, got = _pair_runs(pair, lam, spec, ENGINES[engine], rounds=1)
    check_run(want, got)
    if engine == "sync-device":
        _, sc = pair
        start = sc.program.init(torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(flat(got.final_params), flat(start))
    else:
        assert got.accountant.totals()["abandoned_uploads"] > 0


def test_scenario_default_false_override_and_type(pair, lam):
    """``build_scenario(faults=)`` is the default of ``simulate``,
    ``faults=False`` forces the fault-free path, and anything but a
    ``FaultSpec`` raises ``TypeError``."""
    _, sc = pair
    chaotic = dataclasses.replace(sc, faults=FaultSpec(seed=3, **CHAOS))
    off = chaotic.simulate(lam, 1, faults=False, device="cpu")
    base = sc.simulate(lam, 1, device="cpu")
    np.testing.assert_array_equal(flat(off.final_params), flat(base.final_params))
    assert chaotic.simulate(lam, 1, device="cpu").accountant.totals()["wasted_bits"] > 0
    built = build_scenario("heartbeat", scale=0.02, n_test_per_class=20, device="cpu", faults=FaultSpec(seed=1))
    assert built.faults == FaultSpec(seed=1)
    for bad in (123, object()):
        with pytest.raises(TypeError, match="FaultSpec"):
            sc.simulate(lam, 1, faults=bad, device="cpu")
