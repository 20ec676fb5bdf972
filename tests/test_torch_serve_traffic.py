"""Serving under traffic on every engine of the port against the JAX
package's.

``simulate(serve=TrafficSpec(...))`` hot-swaps the global model behind a
deterministic query stream after each cloud round.  The draws must be
byte-equal to the reference's (a keyed side-channel generator), the serve
records must match the reference's on the same inputs (queries and
staleness exact, ``serve_acc`` within 1e-6: ``scale=0.05``, two cloud
rounds, the reference's initial parameters and cost model), and serving
must not move a trajectory: every engine gives bit-identical parameters,
history and traffic with it on and off.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.serving.traffic import ServeTraffic as RefServeTraffic  # noqa: E402
from repro.serving.traffic import TrafficSpec as RefTrafficSpec  # noqa: E402
from repro_torch.engine import AsyncHFLEngine, BatchedSyncEngine  # noqa: E402
from repro_torch.federated import build_scenario  # noqa: E402
from repro_torch.serving import ServeTraffic, TrafficSpec  # noqa: E402
from torch_parity import ReferencePopulation, check_run, flat, reference_inits  # noqa: E402

# local epochs capped at 4 steps: the reference compiles few cohort shapes
CAPPED = [{"max_steps": 4}] * 18
BUILD = dict(scale=0.05, seed=0, n_test_per_class=20, hparams=CAPPED)
SPEC = dict(queries=40, batch=16, swap_every=2, seed=3)
ENGINES = {
    "reference": ("reference", {}),
    "sync-device": ("sync", {"pipeline": "device"}),
    "sync-host": ("sync", {"pipeline": "host"}),
    "async": ("async", {}),
}


@pytest.fixture(scope="module")
def pair():
    """The heartbeat population in both packages (the port with the
    reference's cost model) and its EARA-SCA assignment; the port's engines
    start from the reference's initial parameters."""
    with reference_inits():
        sc = build_scenario("heartbeat", device="cpu", **BUILD)
        ref = ReferencePopulation(sc)
        sc = dataclasses.replace(sc, cost=ref.cost)
        yield ref, sc, sc.assign("eara-sca", device="cpu").lam


@pytest.fixture(scope="module")
def runs(pair):
    """Per engine: two cloud rounds with serving in the reference, and with
    serving on and off in the port."""
    ref, sc, lam = pair
    out = {}
    for engine, (name, kw) in ENGINES.items():
        rkw = dict(kw, latency=ref.cost.latency) if name == "async" else dict(kw)
        serve = RefServeTraffic(RefTrafficSpec(**SPEC), ref.clients, ref.program)
        want = ref.simulate(lam, 2, engine=name, serve=serve, **rkw)
        on = sc.simulate(lam, 2, engine=name, serve=TrafficSpec(**SPEC), telemetry=True, device="cpu", **kw)
        off = sc.simulate(lam, 2, engine=name, device="cpu", **kw)
        out[engine] = want, on, off
    return out


def test_traffic_spec_validation_and_rounding():
    """As the reference: each field is checked, and the queries round up to
    whole batches."""
    for bad in (dict(queries=0), dict(batch=0), dict(swap_every=0)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            TrafficSpec(**bad)
    for q, b in ((10, 4), (8, 8), (1, 32), (65, 32)):
        assert TrafficSpec(queries=q, batch=b).n_queries() == RefTrafficSpec(queries=q, batch=b).n_queries()
    assert TrafficSpec(queries=10, batch=4).n_queries() == 12


@pytest.mark.parametrize("seed", [0, 7])
def test_draw_byte_equal_to_reference(seed):
    """Rounds 1-5 draw the reference's clients and samples, byte for byte,
    never an empty shard; a round draws the same queries every time."""
    sizes = np.array([0, 5, 9, 3, 0, 17])
    spec, ref = TrafficSpec(queries=10, batch=4, seed=seed), RefTrafficSpec(queries=10, batch=4, seed=seed)
    for b in range(1, 6):
        (c, i), (rc, ri) = spec.draw(b, sizes), ref.draw(b, sizes)
        assert c.dtype == rc.dtype and i.dtype == ri.dtype
        assert c.tobytes() == rc.tobytes() and i.tobytes() == ri.tobytes()
        assert (sizes[c] > 0).all() and ((i >= 0) & (i < sizes[c])).all()
        np.testing.assert_array_equal(spec.draw(b, sizes)[0], c)
    with pytest.raises(ValueError, match="non-empty"):
        spec.draw(1, np.zeros(3))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_serve_history_matches_reference(runs, engine):
    """The serve records against the reference's: rounds, queries and
    staleness (swap every 2 rounds: 0, 1) exact, ``serve_acc`` within 1e-6,
    ``serve_qps`` positive; the training run is held by ``check_run``."""
    want, got, _ = runs[engine]
    assert len(got.serve_history) == len(want.serve_history) == 2
    for rw, rg in zip(want.serve_history, got.serve_history):
        assert set(rg) == set(rw)
        assert (rg["round"], rg["queries"], rg["serve_staleness_rounds"]) == (
            rw["round"], rw["queries"], rw["serve_staleness_rounds"]
        )
        assert rg["serve_acc"] == pytest.approx(rw["serve_acc"], abs=1e-6)
        assert rg["serve_qps"] > 0
    assert [r["serve_staleness_rounds"] for r in got.serve_history] == [0.0, 1.0]
    check_run(want, got)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_serve_on_equals_off(runs, engine):
    """Serving is a pure observer: bit-identical parameters, history and
    traffic with it on and off; a serve-off run has no serve history."""
    _, on, off = runs[engine]
    np.testing.assert_array_equal(flat(on.final_params), flat(off.final_params))
    assert [(m.test_acc, m.mean_local_loss) for m in on.history] == [
        (m.test_acc, m.mean_local_loss) for m in off.history
    ]
    assert on.accountant.totals() == off.accountant.totals()
    assert off.serve_history is None


@pytest.mark.parametrize("engine", list(ENGINES))
def test_serve_telemetry(runs, engine):
    """Under telemetry a round's ``serve_round`` span wraps a ``swap`` span
    on swap rounds only, carries the round's record, and the record lands
    in the round records and the gauges."""
    _, on, _ = runs[engine]
    tel = on.telemetry
    serve = [s for s in tel.tracer.spans if s.name in ("serve_round", "swap")]
    assert [(s.name, s.attrs["round"]) for s in serve] == [("swap", 1), ("serve_round", 1), ("serve_round", 2)]
    for sp, rec in zip([s for s in serve if s.name == "serve_round"], on.serve_history):
        assert {k: sp.attrs[k] for k in rec if k != "round"} == {k: v for k, v in rec.items() if k != "round"}
    for rr, rec in zip(tel.rounds, on.serve_history):
        assert {k: rr[k] for k in ("serve_qps", "serve_staleness_rounds", "serve_acc")} == {
            k: rec[k] for k in ("serve_qps", "serve_staleness_rounds", "serve_acc")
        }
    gauges = tel.metrics.snapshot()["gauges"]
    assert {k: gauges[k] for k in ("serve_qps", "serve_staleness_rounds", "serve_acc")} == {
        k: on.serve_history[-1][k] for k in ("serve_qps", "serve_staleness_rounds", "serve_acc")
    }


def test_swap_every_two_staleness(pair):
    """Swapping every 2 rounds serves fresh, one round stale, fresh; a
    stale round serves the model of the round before, so its record equals
    serving that model again."""
    _, sc, lam = pair
    res = sc.simulate(lam, 3, engine="sync", serve=TrafficSpec(**SPEC), device="cpu")
    assert [r["serve_staleness_rounds"] for r in res.serve_history] == [0.0, 1.0, 0.0]
    assert [r["round"] for r in res.serve_history] == [1, 2, 3]
    fresh = sc.simulate(lam, 1, engine="sync", device="cpu")
    replay = ServeTraffic(TrafficSpec(**SPEC), sc.clients, sc.program, device="cpu")
    replay._params, replay._last_swap = fresh.final_params, 1
    assert replay.on_round(2, lambda: None)["serve_acc"] == res.serve_history[1]["serve_acc"]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_serve_rejects_bad_inputs(pair, engine):
    """As the reference: a ``serve`` that is not a ``TrafficSpec`` raises
    ``TypeError``, and a heterogeneous population ``ValueError``, in
    ``simulate`` and in the engines themselves."""
    _, sc, lam = pair
    name, kw = ENGINES[engine]
    with pytest.raises(TypeError, match="TrafficSpec"):
        sc.simulate(lam, 1, engine=name, serve=32, device="cpu", **kw)
    mix = build_scenario("heartbeat", model_mix={"cnn": 12, "mlp": 6}, scale=0.02, n_test_per_class=4, device="cpu")
    mlam = mix.assign("dba", device="cpu").lam
    with pytest.raises(ValueError, match="heterogeneous"):
        mix.simulate(mlam, 1, engine=name, serve=TrafficSpec(queries=8, batch=8), device="cpu", **kw)
    if name == "reference":
        return  # the readable simulator has no hetero form with a serve hook
    hook = ServeTraffic(TrafficSpec(), mix.clients, mix.program, device="cpu")
    args = (mix.clients, mlam, mix.program, mix.test)
    with pytest.raises(ValueError, match="heterogeneous"):
        if name == "async":
            AsyncHFLEngine(*args, latency=mix.cost.latency, serve=hook, device="cpu")
        else:
            BatchedSyncEngine(*args, serve=hook, device="cpu", **kw)


def test_train_cli_serves(capsys):
    """``--serve 64 --serve-batch 32 --swap-every 2`` prints each round's
    serve accuracy, rate and staleness, as the reference's launcher."""
    from repro_torch.launch import train

    train.main(["--paper", "--serve", "64", "--serve-batch", "32", "--swap-every", "2", "--rounds", "2",
                "--scale", "0.02", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("round ")]
    assert len(lines) == 2
    assert "serve_acc=" in lines[0] and "qps=" in lines[0] and lines[0].endswith("stale=0")
    assert lines[1].endswith("stale=1")
