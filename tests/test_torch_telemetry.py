"""Telemetry on every engine of the port against the JAX package's.

The reference instruments its engines with wall spans, a simulated-time
track, counters and one record per cloud round, and ``Telemetry.jit_cost``
counts a program's FLOPs from its lowered HLO.  Here the port's engines run
beside the reference's on the same inputs (``scale=0.02``, two cloud
rounds, the reference's initial parameters and cost model) and must record
the same spans in the same order with the same attributes (times and cost
aside), the same round records (accuracy to 1e-6, traffic deltas exact),
the same counters, gauges and histograms, and ``kd_loss`` within 1e-5.
Telemetry must not move a trajectory: every engine gives bit-identical
parameters with it on and off.  ``jit_cost`` counts on meta tensors, so it
neither launches a kernel nor draws from a generator; its FLOPs equal the
reference's where both count the same products (``tests/torch_cost_table.py``
prints every key at full size).
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.federated.sampling as ref_sampling  # noqa: E402
from repro.federated import build_scenario as ref_build  # noqa: E402
from repro_torch.engine import StreamSyncEngine  # noqa: E402
from repro_torch.faults import FaultSpec  # noqa: E402
from repro_torch.federated import CohortSpec, build_scenario  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    hier_aggregate,
    hier_aggregate_ref,
    hier_segment_aggregate,
    hier_segment_aggregate_ref,
    launch_counts,
)
from repro_torch.telemetry import (  # noqa: E402
    NULL_TELEMETRY,
    RANGE_PREFIX,
    CommDelta,
    Telemetry,
    coerce_telemetry,
)
from repro_torch.telemetry.metrics import Histogram, MetricsRegistry  # noqa: E402
from repro_torch.telemetry.report import summary_table  # noqa: E402
from repro_torch.telemetry.trace import NULL_SPAN, Tracer  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from torch_cost_table import cost_pairs  # noqa: E402
from torch_parity import ReferencePopulation, flat, reference_costs, reference_inits  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = dict(scale=0.02, seed=0, n_test_per_class=20)
# local epochs capped at 4 steps: the reference compiles few cohort shapes
CAPPED = [{"max_steps": 4}] * 18
MIX = {"cnn": 12, "mlp": 6}
CHAOS = dict(p_drop=0.25, p_rejoin=0.5, p_fail=0.2, max_retries=2, backoff_s=0.1,
             energy_uploads=6.0, refade_rounds=1, drift_rate=0.05)
ENGINES = {
    "reference": ("reference", {}),
    "sync-device": ("sync", {"pipeline": "device"}),
    "sync-host": ("sync", {"pipeline": "host"}),
    "async": ("async", {}),
}
ARTIFACTS = ("trace.json", "trace.jsonl", "rounds.jsonl", "metrics.json", "summary.txt")
COST_ATTRS = {"flops", "bytes_moved"}
STREAM = dict(lazy=True, n_eus=120, n_edges=4, seed=3, n_test_per_class=20)
# the port's own spans (the reference has none of them): left out of the
# comparison with the reference, checked on their own
PORT_SPANS = {"cohort_draw", "batch_plan", "page_in"}


def _pair(**kw):
    sc = build_scenario("heartbeat", device="cpu", hparams=CAPPED, **BUILD, **kw)
    ref = ReferencePopulation(sc)
    sc = dataclasses.replace(sc, cost=ref.cost)
    return ref, sc, sc.assign("eara-sca", device="cpu").lam


@pytest.fixture(scope="module")
def pair():
    """The heartbeat population in both packages (the port with the
    reference's cost model) and its EARA-SCA assignment; the port's engines
    start from the reference's initial parameters."""
    with reference_inits():
        yield _pair()


@pytest.fixture(scope="module")
def mix_pair():
    with reference_inits():
        yield _pair(model_mix=MIX)


@pytest.fixture(scope="module")
def stream_pair():
    ref = ref_build("heartbeat", **STREAM)
    sc = build_scenario("heartbeat", device="cpu", **STREAM)
    with reference_inits():
        yield ref, sc


def _both(ref, sc, lam, engine, **kw):
    """Two telemetry-on cloud rounds of ``engine`` in each package."""
    name, ekw = ENGINES[engine]
    rkw = {**ekw, **kw}
    if name == "async":
        rkw["latency"] = ref.cost.latency
    # under faults both packages price the channel with the reference's costs
    with reference_costs(ref) if "faults" in kw else contextlib.nullcontext():
        want = ref.simulate(lam, 2, engine=name, telemetry=True, **rkw)
        got = sc.simulate(lam, 2, engine=name, telemetry=True, device="cpu", **ekw, **kw)
    assert got.telemetry is not None and want.telemetry is not None
    return want.telemetry, got.telemetry


def _ported(tel):
    """The spans the reference records too."""
    return [s for s in tel.tracer.spans if s.name not in PORT_SPANS]


def _spans(tel, track):
    """(name, attrs) of every span on ``track`` the reference records too,
    in closing order, the cost and the eval accuracy aside."""
    return [
        (s.name, {k: v for k, v in s.attrs.items() if k not in COST_ATTRS | {"acc"}})
        for s in _ported(tel) if s.track == track
    ]


def check_telemetry(want, got):
    """The port's spans, simulated-time track, round records and metrics
    against the reference's."""
    assert _spans(got, "wall") == _spans(want, "wall")
    sim_w = [s for s in want.tracer.spans if s.track == "sim"]
    sim_g = [s for s in got.tracer.spans if s.track == "sim"]
    assert _spans(got, "sim") == _spans(want, "sim")
    for a, b in zip(sim_w, sim_g):
        assert (b.t0, b.t1) == pytest.approx((a.t0, a.t1), abs=1e-9)
    evals = [(s.attrs["acc"], t.attrs["acc"]) for s, t in zip(_ported(want), _ported(got)) if s.name == "eval"]
    assert evals and all(b == pytest.approx(a, abs=1e-6) for a, b in evals)
    assert len(got.rounds) == len(want.rounds) == 2
    for rw, rg in zip(want.rounds, got.rounds):
        # the reference's compile counts have no counterpart: the port compiles nothing per shape
        assert set(rg) == set(rw) - {"jit_cache_sizes"} | {"kernel_launches"}
        for key, value in rw.items():
            if key in ("acc", "loss", "sim_s") and value is not None:
                assert rg[key] == pytest.approx(value, abs=1e-6 if key != "loss" else 1e-5), key
            elif key == "spans":
                counts = {k: v["count"] for k, v in rg[key].items() if k not in PORT_SPANS}
                assert counts == {k: v["count"] for k, v in value.items()}
            elif key not in ("wall_s", "jit_cache_sizes"):
                assert rg[key] == value, key
        assert rg["wall_s"] > 0
    mw, mg = want.metrics.snapshot(), got.metrics.snapshot()
    assert mg["counters"] == mw["counters"]
    assert set(mg["histograms"]) == set(mw["histograms"])
    for name, h in mw["histograms"].items():
        tol = 1e-5 if name == "kd_loss" else 1e-9
        np.testing.assert_allclose(got.metrics.hists[name].samples, want.metrics.hists[name].samples, atol=tol)
        assert mg["histograms"][name]["count"] == h["count"]
    ported = {k for k in mg["gauges"] if not k.startswith(("kernel_launches/", "analytic_"))}
    assert ported == {k for k in mw["gauges"] if not k.startswith("analytic_")}
    for k in ported:
        assert mg["gauges"][k] == pytest.approx(mw["gauges"][k], rel=1e-6, abs=1e-6), k
    assert {k for k in mg["gauges"] if k.startswith("analytic_")} == {
        k for k in mw["gauges"] if k.startswith("analytic_")
    }


def _flat_equal(a, b):
    fa, fb = a.final_params, b.final_params
    if isinstance(fa, dict) and set(fa) == set(MIX):
        return all(np.array_equal(flat(fa[k]), flat(fb[k])) for k in fa)
    return np.array_equal(flat(fa), flat(fb))


# -- the facade: tracer, metrics, null telemetry (ported unit tests) ----------
def test_span_nesting_and_parents():
    tr = Tracer()
    with tr.span("outer", kind="test") as outer:
        with tr.span("inner"):
            pass
        outer.set(extra=1)
    spans = {s.name: s for s in tr.spans}
    assert spans["inner"].parent == spans["outer"].sid
    assert spans["outer"].parent is None
    assert spans["outer"].attrs == {"kind": "test", "extra": 1}
    assert spans["outer"].t0 <= spans["inner"].t0 <= spans["inner"].t1 <= spans["outer"].t1


def test_trace_export_round_trip(tmp_path):
    tr = Tracer()
    with tr.span("a", x=1):
        pass
    tr.sim_span("up", 0.5, 1.5, client=3)
    rows = [json.loads(line) for line in tr.write_jsonl(tmp_path / "t.jsonl").read_text().splitlines()]
    assert {r["name"] for r in rows} == {"a", "up"}
    assert {r["track"] for r in rows} == {"wall", "sim"}
    evs = json.loads(tr.write_chrome_trace(tmp_path / "t.json").read_text())["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {1, 2}
    sim = next(e for e in xs if e["pid"] == 2)
    assert sim["ts"] == pytest.approx(0.5e6) and sim["dur"] == pytest.approx(1.0e6)
    assert any(e["ph"] == "M" for e in evs)


def test_null_telemetry_is_noop():
    assert NULL_TELEMETRY.span("x") is NULL_SPAN
    with NULL_TELEMETRY.span("x") as sp:
        sp.set(a=1)
    assert NULL_TELEMETRY.jit_cost("k", lambda: 0) is None
    NULL_TELEMETRY.observe_later("k", torch.zeros(()))
    assert NULL_TELEMETRY.on_round(round=1) == {}
    assert NULL_TELEMETRY.flush() == {}
    assert not NULL_TELEMETRY.enabled


def test_coerce_telemetry(tmp_path):
    assert coerce_telemetry(None) is None
    assert coerce_telemetry(False) is None
    assert coerce_telemetry(NULL_TELEMETRY) is None
    t = coerce_telemetry(True)
    assert isinstance(t, Telemetry) and t.out_dir is None
    assert coerce_telemetry(t) is t
    assert coerce_telemetry(str(tmp_path / "out")).out_dir is not None
    with pytest.raises(TypeError):
        coerce_telemetry(42)


def test_histogram_and_registry():
    h = Histogram()
    for v in [1.0, 2.0, 3.0, 4.0]:
        h.observe(v)
    s = h.summary()
    assert s["count"] == 4 and s["mean"] == pytest.approx(2.5) and (s["min"], s["max"]) == (1.0, 4.0)
    m = MetricsRegistry()
    m.inc("n")
    m.inc("n", 2)
    m.set_gauge("g", 7.5)
    m.observe("h", 1.0)
    snap = m.snapshot()
    assert snap["counters"]["n"] == 3 and snap["gauges"]["g"] == 7.5 and snap["histograms"]["h"]["count"] == 1


def test_summary_table_shape():
    rounds = [{"round": 1, "acc": 0.5, "loss": 0.2, "wall_s": 1.0, "sim_s": None,
               "eu_up_bits": 8e6, "eu_down_bits": 8e6, "cloud_bits": 4e6}]
    lines = summary_table(rounds).splitlines()
    assert "round" in lines[0] and "acc" in lines[0] and len(lines) == 3
    assert "(no rounds recorded)" in summary_table([])


def test_comm_delta(pair):
    _, sc, lam = pair
    res = sc.simulate(lam, 1, engine="sync", device="cpu")
    cd = CommDelta(res.accountant)
    assert cd.take()["eu_up_bits"] == 0.0
    res.accountant.on_eu_exchange(0, up_bits=8.0)
    assert cd.take()["eu_up_bits"] == 8.0
    assert cd.take()["eu_up_bits"] == 0.0


def test_observe_later_reads_at_on_round():
    """A device scalar handed to ``observe_later`` is read at the next
    round record, not before."""
    tel = Telemetry()
    tel.observe_later("kd_loss", torch.tensor(1.5))
    assert "kd_loss" not in tel.metrics.hists
    tel.on_round(round=1)
    assert tel.metrics.hists["kd_loss"].samples == [1.5]
    tel.on_round(round=2)
    assert tel.metrics.hists["kd_loss"].samples == [1.5]


def test_round_records_count_kernel_launches(monkeypatch):
    """``kernel_launches`` in a record is each kernel's launches since the
    previous record, and survives a counter reset in between."""
    tel = Telemetry()
    monkeypatch.setattr(hier_aggregate, "launches", hier_aggregate.launches + 3)
    assert tel.on_round(round=1)["kernel_launches"]["hier_aggregate"] == 3
    assert tel.on_round(round=2)["kernel_launches"]["hier_aggregate"] == 0
    monkeypatch.setattr(hier_aggregate, "launches", 1)
    rec = tel.on_round(round=3)
    assert rec["kernel_launches"]["hier_aggregate"] == 1
    assert tel.metrics.gauges["kernel_launches/hier_aggregate"] == 1


# -- jit_cost --------------------------------------------------------------------
def test_jit_cost_cached():
    tel = Telemetry()
    calls = []
    orig = tel._analyze

    def counting(key, fn, args, kwargs):
        calls.append(key)
        return orig(key, fn, args, kwargs)

    tel._analyze = counting
    c1 = tel.jit_cost("mm", lambda a, b: a @ b, torch.ones((4, 8)), torch.ones((8, 2)))
    c2 = tel.jit_cost("mm", lambda a, b: a @ b, torch.ones((4, 8)), torch.ones((8, 2)))
    assert c1 == c2 and c1["flops"] == 2 * 4 * 8 * 2
    assert calls == ["mm"]  # the second call was a cache hit
    tel.jit_cost("mm", lambda a, b: a @ b, torch.ones((2, 8)), torch.ones((8, 2)))
    assert calls == ["mm", "mm"]  # a new shape is counted again
    assert tel.metrics.gauges["analytic_flops/mm"] == 2 * 2 * 8 * 2


def test_jit_cost_never_runs_on_the_data():
    """The program sees meta tensors only, and a program that cannot run on
    them (or is given no tensor) is not analysed: ``None``, as in the
    reference."""
    seen = []

    def probe(a):
        seen.append(a.device.type)
        return a * 2

    tel = Telemetry()
    x = torch.ones(3)
    assert tel.jit_cost("probe", probe, x) == {"flops": 0.0, "bytes_moved": 12.0}
    assert seen == ["meta"] and torch.equal(x, torch.ones(3))
    assert tel.jit_cost("host", lambda a: float(a.sum()), x) is None
    assert tel.jit_cost("no_inputs", lambda: torch.ones(2) @ torch.ones(2)) is None
    assert "analytic_flops/host" not in tel.metrics.gauges


@pytest.mark.parametrize("c,steps", [(3, 4), (2, 9)])
def test_jit_cost_flops_equal_reference(c, steps):
    """FLOPs equal to the reference's HLO count for the cohort epoch (C 3,
    S 4: 109,962,240) and the cloud reduce (N 5, D 25,141: 251,410); the
    segment FedAvg counts none in either.  The keys whose reference
    programs run XLA convolutions (the host pipeline's epoch, the fuse),
    which ``hlo_stats`` does not count, differ by design."""
    pairs = cost_pairs(c=c, steps=steps, batch=10, n_edges=5, kd_steps=2, kd_batch=4)
    for key in ("cohort_epoch_flat", "segment_agg_keep", "cloud_reduce"):
        port, ref = pairs[key]
        assert port["flops"] == ref["flops"], key
    if (c, steps) == (3, 4):
        assert pairs["cohort_epoch_flat"][0]["flops"] == 109_962_240
    assert pairs["cloud_reduce"][0]["flops"] == 251_410
    for key, (port, ref) in pairs.items():
        assert port is not None and ref is not None and port["bytes_moved"] > 0, key


def test_jit_cost_mapped_cohort_counts_each_client():
    """The host pipeline's epoch (``impl="xla"``, the convolution mapped
    over the clients by ``torch.func.vmap``) is counted at one client and
    scaled by C, so at C 3 it counts the FLOPs of the GEMM form
    (109,962,240), not the 174,282,240 of the mapped program counted
    whole, whose convolution backward the flop formula over-counts."""
    pairs = cost_pairs(c=3, steps=4, batch=10, n_edges=5, kd_steps=2, kd_batch=4)
    flat_form, mapped = pairs["cohort_epoch_flat"][0], pairs["cohort_epoch"][0]
    assert mapped["flops"] == flat_form["flops"] == 109_962_240
    one = cost_pairs(c=1, steps=4, batch=10, n_edges=5, kd_steps=2, kd_batch=4)["cohort_epoch"][0]
    assert mapped == {k: 3 * v for k, v in one.items()}


def test_jit_cost_step_loop_is_exact():
    """A ``step_loop`` program counted at 1 and 2 steps and extrapolated
    equals the count of all its steps, FLOPs and bytes alike; at the full
    heartbeat cohort the FLOPs are 18 x 128 x one client-step's."""
    from repro_torch.engine.cohort import _cohort_epoch_flat
    from repro_torch.engine.distill import DistillSpec, _distill_fuse_one
    from repro_torch.federated import CNNProgram
    from repro_torch.telemetry import _count, _to_meta, analytic_cost

    prog = CNNProgram()
    spec = _spec_of(prog)
    d = spec.total_size

    def epoch_args(c, s):
        return (torch.zeros((c, d)), torch.zeros((c, s, 10, 187, 1)), torch.zeros((c, s, 10), dtype=torch.int32),
                spec, prog, s, 1e-3)

    args = epoch_args(2, 5)
    assert analytic_cost(_cohort_epoch_flat, args, {}) == _count(_cohort_epoch_flat, _to_meta(args), {})
    dspec = DistillSpec(steps=5, batch=4)
    fargs = (torch.zeros((3, d)), torch.zeros((5, 3, 4, 187, 1)), torch.zeros((5, 3, 4, 5)), prog, spec, dspec)
    assert analytic_cost(_distill_fuse_one, fargs, {}) == _count(_distill_fuse_one, _to_meta(fargs), {})
    one = analytic_cost(_cohort_epoch_flat, epoch_args(1, 1), {})["flops"]
    assert analytic_cost(_cohort_epoch_flat, epoch_args(18, 128), {})["flops"] == 18 * 128 * one == 21_112_750_080


def _spec_of(prog):
    from repro_torch.engine import FlatPack

    return FlatPack(prog.init(torch.Generator().manual_seed(0))).spec


def test_meta_tensors_take_the_plain_version(monkeypatch):
    """A meta tensor takes each FedAvg wrapper's plain version: the launch
    is never reached and no launch is counted."""
    import importlib

    for mod in ("repro_torch.kernels.hier_aggregate", "repro_torch.kernels.segment_aggregate"):
        monkeypatch.setattr(importlib.import_module(mod), "_launch", _no_launch)
    before = launch_counts()
    u, w = torch.empty((5, 7), device="meta"), torch.empty(5, device="meta")
    out = hier_aggregate(u, w)
    assert out.device.type == "meta" and out.shape == (7,)
    seg = torch.empty(5, dtype=torch.int64, device="meta")
    out = hier_segment_aggregate(u, seg, w, 3)
    assert out.device.type == "meta" and out.shape == (3, 7)
    assert launch_counts() == before
    # the CPU still takes the plain version, and so does a meta pass of it
    x, wt = torch.randn(5, 7), torch.rand(5)
    assert torch.equal(hier_aggregate(x, wt), hier_aggregate_ref(x, wt))
    ids = torch.tensor([0, 2, 2, 1, 0])
    assert torch.equal(hier_segment_aggregate(x, ids, wt, 3), hier_segment_aggregate_ref(x, ids, wt, 3))


def _no_launch(*args, **kwargs):
    raise AssertionError("a meta or CPU tensor reached a kernel launch")


# -- the engines against the reference --------------------------------------------
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_telemetry_matches_reference(pair, engine):
    """Spans (names, order, attributes), the simulated-time track (async),
    round records, counters, gauges and histograms (``cohort_size``,
    ``cohort_padding_waste``, ``async_staleness``) as the reference's."""
    ref, sc, lam = pair
    check_telemetry(*_both(ref, sc, lam, engine))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_telemetry_under_chaos_faults(pair, engine):
    """The chaos fault spec: the ``faults_*`` counters, ``faults_live`` and
    ``faults_energy_remaining_j`` and the async engine's retry track as the
    reference's."""
    ref, sc, lam = pair
    want, got = _both(ref, sc, lam, engine, faults=FaultSpec(seed=1, **CHAOS))
    check_telemetry(want, got)
    assert "faults_live" in got.metrics.gauges


@pytest.mark.parametrize("engine", ["reference", "sync-device", "sync-host", "async"])
def test_mixed_population_telemetry_matches_reference(mix_pair, engine):
    """A mixed population (12 CNN EUs, 6 MLP EUs): the ``kd_fuse`` span,
    ``kd_loss`` within 1e-5 and ``group_clients/<program>``."""
    ref, sc, lam = mix_pair
    want, got = _both(ref, sc, lam, engine)
    check_telemetry(want, got)
    assert any(s.name == "kd_fuse" for s in got.tracer.spans)
    assert got.metrics.hists["kd_loss"].count > 0


def test_stream_telemetry_matches_reference(stream_pair):
    """``StreamSyncEngine``: the spans (one ``cohort_epoch`` per step-bucket
    group, one ``edge_aggregate`` a round) and the page gauges as the
    reference's, evictions included."""
    ref, sc = stream_pair
    kw = dict(cloud_rounds=2, seed=0, page_slots=24, telemetry=True)
    want = ref.simulate(ref_sampling.CohortSpec(size=24, seed=9), **kw).telemetry
    got = sc.simulate(CohortSpec(size=24, seed=9), device="cpu", **kw).telemetry
    check_telemetry(want, got)
    assert got.metrics.gauges["page_evictions"] > 0
    # the port's own spans: one of each a round, under the parents they time
    by_sid = {s.sid: s for s in got.tracer.spans}
    parents = {s.name: by_sid[s.parent].name for s in got.tracer.spans if s.name in PORT_SPANS}
    assert parents == {"cohort_draw": "assignment", "batch_plan": "assignment", "page_in": "cloud_round"}
    assert all({k: r["spans"][k]["count"] for k in PORT_SPANS} == dict.fromkeys(PORT_SPANS, 1) for r in got.rounds)


# -- telemetry moves no trajectory ---------------------------------------------------
def _run_pair(sc, lam, kind):
    if kind == "stream":
        return [sc.simulate(CohortSpec(size=24, seed=9), cloud_rounds=2, page_slots=24, device="cpu",
                            telemetry=t) for t in (None, True)]
    name, kw = ENGINES[kind]
    return [sc.simulate(lam, 2, engine=name, device="cpu", telemetry=t, **kw) for t in (None, True)]


@pytest.mark.parametrize("kind", list(ENGINES) + ["stream", "mix-sync-device", "mix-async"])
def test_bit_identical_on_vs_off(pair, mix_pair, stream_pair, kind):
    """Every engine's trajectory and final parameters are bit-identical with
    telemetry on and off (no extra pass on the data, no generator draw),
    and the async engine's simulated clock is the same."""
    if kind == "stream":
        sc, lam = stream_pair[1], None
    elif kind.startswith("mix-"):
        (_, sc, lam), kind = mix_pair, kind[4:]
    else:
        _, sc, lam = pair
    off, on = _run_pair(sc, lam, kind)
    assert off.telemetry is None and on.telemetry is not None
    fields = lambda r: [(m.cloud_round, m.test_acc, m.divergence, m.mean_local_loss, m.sim_seconds)  # noqa: E731
                        for m in r.history]
    assert fields(off) == fields(on)
    assert _flat_equal(off, on)
    assert off.accountant.totals() == on.accountant.totals()


def test_cohort_epoch_cost_on_the_span(pair):
    """The device pipeline's ``cohort_epoch`` spans carry the analytic cost,
    the same as ``jit_cost`` gives for the cohort's shape."""
    _, sc, lam = pair
    tel = sc.simulate(lam, 1, engine="sync", device="cpu", telemetry=True).telemetry
    spans = [s for s in tel.tracer.spans if s.name == "cohort_epoch"]
    assert spans and all(s.attrs["flops"] > 0 and s.attrs["bytes_moved"] > 0 for s in spans)
    reduce = [s for s in tel.tracer.spans if s.name == "cloud_reduce"]
    assert reduce[0].attrs["flops"] == 2 * sc.n_edges * _spec_of(sc.program).total_size


# -- spans on the profiler's clock ---------------------------------------------------
def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``; returns (its value, the
    ``tel:`` ranges as (name, start_ns, end_ns) in order of start)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name()[len(RANGE_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.activity_type() == "user_annotation" and e.name().startswith(RANGE_PREFIX)]
    return out, sorted(ranges, key=lambda r: (r[1], -r[2]))


def _innermost_parent(ranges, i):
    """The name of the shortest range that holds range ``i``, or None."""
    _, s, e = ranges[i]
    around = [r for j, r in enumerate(ranges) if j != i and r[1] <= s and e <= r[2]]
    return min(around, key=lambda r: r[2] - r[1])[0] if around else None


def check_ranges(tel, ranges):
    """One ``tel:`` range per wall span of ``tel``: the same names in the
    same order of opening, nested as the spans are."""
    spans = sorted((s for s in tel.tracer.spans if s.track == "wall"), key=lambda s: (s.t0, -s.t1))
    assert [r[0] for r in ranges] == [s.name for s in spans]
    by_sid = {s.sid: s for s in spans}
    for i, s in enumerate(spans):
        assert _innermost_parent(ranges, i) == (by_sid[s.parent].name if s.parent is not None else None), s.name


def test_span_is_a_profiler_range_only_while_one_records():
    """A wall span opens a ``tel:`` range with it while a profiler records
    (nested as the spans are), none otherwise; the null telemetry none."""
    def nest(tel):
        with tel.span("outer"):
            with tel.span("inner") as sp:
                opened = getattr(sp, "_range", None) is not None
        return opened

    quiet = Telemetry()
    assert not nest(quiet) and [s.name for s in quiet.tracer.spans] == ["inner", "outer"]
    tel = Telemetry()
    opened, ranges = _profiled(lambda: nest(tel))
    assert opened and [r[0] for r in ranges] == ["outer", "inner"]
    check_ranges(tel, ranges)
    assert _profiled(lambda: nest(NULL_TELEMETRY)) == (False, [])


def _stream_engine(sc, telemetry):
    return StreamSyncEngine(sc.source, sc.edge_of, sc.program, sc.test, cohort=CohortSpec(size=24, seed=9),
                            n_edges=sc.n_edges, seed=0, page_slots=24, telemetry=telemetry, device="cpu")


@pytest.mark.parametrize("on", [True, False])
def test_stream_round_ranges_follow_the_spans(stream_pair, on):
    """A telemetry-on ``StreamSyncEngine`` round under a profiler: one
    ``tel:`` range per wall span, same names and nesting; off, none."""
    eng = _stream_engine(stream_pair[1], on)
    res, ranges = _profiled(lambda: eng.run(1))
    if not on:
        assert ranges == [] and res.telemetry is None
        return
    check_ranges(res.telemetry, ranges)
    names = [r[0] for r in ranges]
    assert names[:5] == ["cloud_round", "assignment", "cohort_draw", "batch_plan", "page_in"]
    assert names[-2:] == ["cloud_reduce", "eval"]


HFL_ARCH = "phi3-mini-3.8b"


def _hfl_state(n_edges=2, seed=0):
    """A smoke-size phi3 as ``n_edges`` replicas with Adam moments, and an
    (E, 1, 16) token batch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import init_hfl_state
    from repro_torch.models.transformer import init_params
    from repro_torch.training import adam

    cfg = get_smoke_config(HFL_ARCH)
    opt = adam(1e-3)
    state = init_hfl_state(init_params(torch.Generator().manual_seed(seed), cfg), opt, n_edges)
    toks = torch.randint(0, cfg.vocab_size, (n_edges, 1, 17), generator=torch.Generator().manual_seed(seed + 1))
    return cfg, opt, state, {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("on", [True, False])
def test_hfl_step_ranges_follow_the_spans(sync, on):
    """``make_hfl_train_step(telemetry=)``: ``hfl_step``, in it each edge's
    ``loss_grad``, ``clip`` and ``adam`` and, syncing, ``cloud_avg``, each
    a ``tel:`` range under a profiler; off, no range."""
    from repro_torch.distributed import make_hfl_train_step

    cfg, opt, state, batch = _hfl_state()
    tel = Telemetry() if on else None
    step = make_hfl_train_step(cfg, opt, sync=sync, telemetry=tel)
    _, ranges = _profiled(lambda: step(state, batch))
    if not on:
        assert ranges == []
        return
    check_ranges(tel, ranges)
    edges = ["loss_grad", "clip", "adam"] * 2
    assert [r[0] for r in ranges] == ["hfl_step"] + edges + (["cloud_avg"] if sync else [])
    attrs = {s.name: s.attrs for s in tel.tracer.spans}
    assert attrs["hfl_step"] == {"sync": sync, "edges": 2}
    assert [s.attrs["edge"] for s in tel.tracer.spans if s.name == "adam"] == [0, 1]
    if sync:
        assert attrs["cloud_avg"] == {"leaves": len(tree_leaves(state.params)), "sync_opt_state": False}


def test_hfl_step_bit_identical_on_vs_off():
    """Telemetry on and off give bit-identical replicas, moments and
    metrics over a local and a sync step; ``tokens_trained`` counts the
    E x B x S tokens of each step and ``sync_steps`` the syncs."""
    from repro_torch.distributed import make_hfl_train_step

    runs = []
    for tel in (None, Telemetry()):
        cfg, opt, state, batch = _hfl_state()
        metrics = []
        for sync in (False, True):
            state, m = make_hfl_train_step(cfg, opt, sync=sync, telemetry=tel)(state, batch)
            metrics.append(m)
        runs.append((state, metrics, tel))
    (off, m_off, _), (on, m_on, tel) = runs
    for a, b in zip(tree_leaves((off.params, off.opt_state)), tree_leaves((on.params, on.opt_state)), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(m_off, m_on):
        assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    assert tel.metrics.counters == {"tokens_trained": 2 * batch["tokens"].numel(), "sync_steps": 1}


# -- artifacts -------------------------------------------------------------------------
def _check_artifacts(out: Path, span_names):
    for name in ARTIFACTS:
        assert (out / name).exists(), name
    doc = json.loads((out / "trace.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert set(span_names) <= names
    rounds = [json.loads(line) for line in (out / "rounds.jsonl").read_text().splitlines()]
    assert rounds and all(r["wall_s"] > 0 and "spans" in r and "kernel_launches" in r and "jit_cache_sizes" not in r
                          for r in rounds)
    assert (out / "summary.txt").read_text().strip()
    return rounds


@pytest.mark.parametrize("engine", ["reference", "sync-device", "async", "stream"])
def test_simulate_writes_artifacts(tmp_path, pair, stream_pair, engine):
    out = tmp_path / engine
    if engine == "stream":
        stream_pair[1].simulate(CohortSpec(size=24, seed=9), cloud_rounds=1, device="cpu", telemetry=str(out))
        spans = ["assignment", "cohort_epoch", "edge_aggregate", "cloud_reduce", "eval", "cloud_round"]
    else:
        _, sc, lam = pair
        name, kw = ENGINES[engine]
        sc.simulate(lam, 1, engine=name, device="cpu", telemetry=out, **kw)
        train = "local_train" if engine == "reference" else "cohort_epoch"
        spans = ["assignment", train, "edge_aggregate", "cloud_reduce", "eval", "cloud_round"]
    rounds = _check_artifacts(out, spans)
    assert [r["round"] for r in rounds] == [1]


def test_simulate_flushes_when_the_run_raises(tmp_path, pair, monkeypatch):
    """A directory gets its artifacts even when the run raises."""
    from repro_torch.engine import BatchedSyncEngine

    _, sc, lam = pair

    def boom(self, *a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(BatchedSyncEngine, "run", boom)
    with pytest.raises(RuntimeError, match="boom"):
        sc.simulate(lam, 1, engine="sync", device="cpu", telemetry=tmp_path / "out")
    assert (tmp_path / "out" / "summary.txt").exists()


def test_stream_engine_takes_a_telemetry_object(stream_pair):
    sc = stream_pair[1]
    tel = Telemetry()
    eng = StreamSyncEngine(sc.source, sc.edge_of, sc.program, sc.test, cohort=CohortSpec(size=24, seed=9),
                           n_edges=sc.n_edges, seed=0, telemetry=tel, device="cpu")
    res = eng.run(1)
    assert res.telemetry is tel and len(tel.rounds) == 1
    assert {"page_hits", "page_misses", "page_evictions", "participating"} <= set(tel.metrics.gauges)


def _train_cli(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_cli_paper_writes_artifacts(tmp_path):
    """``python -m repro_torch.launch.train --paper --device cpu --telemetry
    DIR`` runs the paper experiment and writes the five artifacts."""
    out = tmp_path / "cli"
    proc = _train_cli("--paper", "--device", "cpu", "--rounds", "1", "--scale", "0.02", "--engine", "sync",
                      "--telemetry", str(out))
    assert proc.returncode == 0, proc.stderr
    assert "round 1: acc=" in proc.stdout and "telemetry artifacts in" in proc.stdout
    _check_artifacts(out, ["assignment", "cohort_epoch", "edge_aggregate", "cloud_reduce", "eval", "cloud_round"])


def test_train_cli_refuses_unported_modes(monkeypatch):
    """Both modes default to the card: without CUDA, ``--arch`` (ported:
    ``tests/test_torch_train.py``) and ``--paper`` raise naming the device
    (``--serve`` is ported: ``tests/test_torch_serve_traffic.py``)."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device="):
        train.main(["--arch", "qwen3-14b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device="):
        train.main(["--paper", "--rounds", "1"])
