"""The spans pass (``bench/spans.py``) and its readers on made-up traces,
and the pass's work on the smoke cells."""
from __future__ import annotations

import pytest

import bench_smoke
from bench import harness, spans

FL_NAMES = ("fl_idle_ms.assign", "fl_idle_ms.page", "fl_idle_ms.eval", "fl_idle_ms.other")
LM_NAMES = ("lm_busy_ms.loss_grad", "lm_busy_ms.clip", "lm_busy_ms.adam", "lm_busy_ms.cloud_avg")


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def _ctx(name, span_trace, trace=None):
    cell = bench_smoke.cell(name)
    counters = {}
    if name == bench_smoke.LM_CELL:  # the driver's, which the readers take the tokens a step from
        counters = {"edges": cell.config["edges"], "batch": cell.traffic["batch"], "seq": cell.traffic["seq_len"]}
    return {"cell": cell, "trace": trace or harness.Trace(1.0, [], []), "counters": counters, "spans": span_trace}


def _fl_round(t0):
    """One made-up round from ``t0``: its ranges and its two device
    operations (a cohort epoch running past its span, the eval's)."""
    tel = [("cloud_round", 0.0, 0.5), ("assignment", 0.0, 0.1), ("cohort_draw", 0.0, 0.04),
           ("batch_plan", 0.05, 0.05), ("page_in", 0.1, 0.05), ("cohort_epoch", 0.15, 0.2), ("eval", 0.4, 0.1)]
    ranges = [("run(1)", t0, 0.5)] + [(spans.TEL + n, t0 + s, d) for n, s, d in tel]
    ops = [("gemm", t0 + 0.16, 0.24), ("eval_kernel", t0 + 0.42, 0.03)]
    return ranges, ops, [t0 + 0.15, t0 + 0.41]


def fl_trace(drop=()):
    ranges, ops, launch = [("window", 0.0, 1.0)], [], []
    for t0 in (0.0, 0.5):
        r, o, lt = _fl_round(t0)
        ranges += [x for x in r if x[0][len(spans.TEL):] not in drop]
        ops += o
        launch += lt
    return spans.SpanTrace(1.0, ops, ranges, launch=launch)


def test_fl_idle_splits_each_gap_where_spans_change():
    """A round idles 0.16 s before its epoch's kernel (cohort draw 0.04,
    assignment 0.01, batch plan 0.05, page-in 0.05, the epoch 0.01) and
    0.07 s in its eval: the four readers split it by overlap and sum to
    the idle time a round.  The breakdown puts each gap whole under the
    span open at its start (round 1's eval gap runs on into round 2's
    draw)."""
    t = fl_trace()
    ctx = _ctx(bench_smoke.FL_CELL, t)
    got = {n: _reader(n).read(ctx) for n in FL_NAMES}
    assert got == pytest.approx({"fl_idle_ms.assign": 100.0, "fl_idle_ms.page": 50.0, "fl_idle_ms.eval": 70.0,
                                 "fl_idle_ms.other": 10.0})
    assert sum(got.values()) == pytest.approx(1e3 * (t.window_s - t.busy_s()) / 2)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"tel:cohort_draw": 0.16, "tel:eval": 0.30})


@pytest.mark.parametrize("missing, silent", [("page_in", {"fl_idle_ms.page"}),
                                             ("batch_plan", {"fl_idle_ms.assign"}),
                                             ("cloud_round", set(FL_NAMES))])
def test_fl_idle_needs_its_ranges(missing, silent):
    """A reader whose ranges the trace lacks gives no number; the others
    still read."""
    ctx = _ctx(bench_smoke.FL_CELL, fl_trace(drop=(missing,)))
    got = {n: _reader(n).read(ctx) for n in FL_NAMES}
    assert {n for n, v in got.items() if v is None} == silent


def lm_trace(drop=(), lost=0.0, uncounted=()):
    """Two made-up steps, the second a sync: each edge's ops launched in
    its spans and run later on the card, one op launched in ``hfl_step``
    outside any edge's span, and (``lost``) an op with no launch found;
    the program's counters as the two steps leave them (less
    ``uncounted``)."""
    ranges, ops, launch = [("window", 0.0, 1.0)], [], []
    for t0, sync in ((0.0, False), (0.5, True)):
        tel = [("hfl_step", 0.0, 0.4), ("loss_grad", 0.0, 0.1), ("clip", 0.1, 0.05), ("adam", 0.15, 0.15)]
        if sync:
            tel.append(("cloud_avg", 0.3, 0.05))
        ranges += [(spans.TEL + n, t0 + s, d) for n, s, d in tel if n not in drop]
        step = [("fwd", 0.01, 0.02, 0.10), ("bwd", 0.05, 0.12, 0.08), ("norm", 0.11, 0.20, 0.05),
                ("adam", 0.2, 0.25, 0.1), ("stack", 0.32 if not sync else 0.36, 0.38, 0.01)]
        if sync:
            step.append(("aggregate_kernel", 0.31, 0.35, 0.03))
        for name, at, start, dur in step:
            ops.append((name, t0 + start, dur))
            launch.append(t0 + at)
    if lost:
        ops.append(("lost", 0.99, lost))
        launch.append(None)
    c = _ctx(bench_smoke.LM_CELL, None)["counters"]
    counters = {"tokens_trained": 2 * c["edges"] * c["batch"] * c["seq"], "sync_steps": 1}
    return spans.SpanTrace(1.0, ops, ranges, launch=launch,
                           counters={k: v for k, v in counters.items() if k not in uncounted})


def test_lm_busy_splits_device_time_by_launch_span():
    """Busy time goes to the span innermost-open at each op's launch, not
    where the op ran: loss and backward 0.18 s a step, clip 0.05, Adam
    0.1, and the sync's 0.03 of averaging, run while nothing of the step
    is open any more, ``cloud_avg``'s, per sync step; what ``hfl_step``
    launches itself is the remainder."""
    t = lm_trace()
    ctx = _ctx(bench_smoke.LM_CELL, t)
    got = {n: _reader(n).read(ctx) for n in LM_NAMES}
    assert got == pytest.approx({"lm_busy_ms.loss_grad": 180.0, "lm_busy_ms.clip": 50.0, "lm_busy_ms.adam": 100.0,
                                 "lm_busy_ms.cloud_avg": 30.0})
    covered = 2 * (got["lm_busy_ms.loss_grad"] + got["lm_busy_ms.clip"] + got["lm_busy_ms.adam"])
    covered += got["lm_busy_ms.cloud_avg"]
    assert 1e3 * t.busy_s() - covered == pytest.approx(20.0)  # the two stacks, under tel:hfl_step
    assert t.busy_by_launch()["tel:hfl_step"] == pytest.approx(0.02)


@pytest.mark.parametrize("missing, silent", [("cloud_avg", {"lm_busy_ms.cloud_avg"}),
                                             ("clip", {"lm_busy_ms.clip"}),
                                             ("loss_grad", {"lm_busy_ms.loss_grad"})])
def test_lm_busy_needs_its_ranges(missing, silent):
    ctx = _ctx(bench_smoke.LM_CELL, lm_trace(drop=(missing,)))
    got = {n: _reader(n).read(ctx) for n in LM_NAMES}
    assert {n for n, v in got.items() if v is None} == silent


@pytest.mark.parametrize("missing, silent", [("tokens_trained", set(LM_NAMES) - {"lm_busy_ms.cloud_avg"}),
                                             ("sync_steps", {"lm_busy_ms.cloud_avg"})])
def test_lm_busy_counts_steps_by_the_program_counters(missing, silent):
    """Steps are the program's ``tokens_trained`` over the cell's tokens a
    step, sync steps its ``sync_steps``: a pass whose program counted
    neither gives no number, and a step count read off the counters
    divides the busy time."""
    ctx = _ctx(bench_smoke.LM_CELL, lm_trace(uncounted=(missing,)))
    got = {n: _reader(n).read(ctx) for n in LM_NAMES}
    assert {n for n, v in got.items() if v is None} == silent
    ctx = _ctx(bench_smoke.LM_CELL, lm_trace())
    ctx["spans"].counters = {k: 2 * v for k, v in ctx["spans"].counters.items()}
    assert _reader("lm_busy_ms.clip").read(ctx) == pytest.approx(25.0)
    assert _reader("lm_busy_ms.cloud_avg").read(ctx) == pytest.approx(15.0)


def test_unmatched_launches_silence_the_readers():
    """Over 1% of the device time with no launch found: no reader gives a
    number; at under 1% they all do."""
    assert all(_reader(n).read(_ctx(bench_smoke.LM_CELL, lm_trace(lost=0.005))) is not None for n in LM_NAMES)
    ctx = _ctx(bench_smoke.LM_CELL, lm_trace(lost=0.05))
    assert ctx["spans"].unmatched_share() > spans.UNMATCHED_MAX
    assert all(_reader(n).read(ctx) is None for n in LM_NAMES)


class _Event:
    """A kineto event as ``bench/harness.py`` and ``bench/spans.py`` read one."""

    def __init__(self, name, kind, start_ns, dur_ns, corr=0):
        self._v = (name, kind, start_ns, dur_ns, corr)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def made_up_events(w0=10_000):
    """A host-and-device profile of one round: the harness's window and
    ``run(1)`` ranges, the program's spans, launches and their kernels
    (one kernel whose launch event is missing)."""
    ms = 1_000_000
    ev = [_Event("bench:window", "user_annotation", w0, 100 * ms), _Event("bench:run(1)", "user_annotation", w0, 90 * ms)]
    for name, s, d in (("cloud_round", 0, 80), ("assignment", 0, 20), ("cohort_draw", 0, 10), ("batch_plan", 10, 10),
                       ("page_in", 20, 10), ("cohort_epoch", 30, 20), ("eval", 60, 20)):
        ev.append(_Event("tel:" + name, "user_annotation", w0 + s * ms, d * ms))
    ev += [_Event("aten::add_", "cpu_op", w0 + 31 * ms, ms),
           _Event("cudaLaunchKernel", "cuda_runtime", w0 + 31 * ms, ms // 10, corr=7),
           _Event("gemm", "kernel", w0 + 32 * ms, 30 * ms, corr=7),
           _Event("cuLaunchKernel", "cuda_driver", w0 + 61 * ms, ms // 10, corr=8),
           _Event("Lazy Function Loading", "cpu_op", w0 + 65 * ms, ms, corr=9),  # not a launch
           _Event("eval_kernel", "kernel", w0 + 62 * ms, 5 * ms, corr=8),
           _Event("memset", "gpu_memset", w0 + 70 * ms, ms // 1000, corr=9),
           _Event("outside", "kernel", w0 - 50 * ms, ms, corr=10)]
    return ev, w0, 100 * ms


class _OldEvent(_Event):
    """An event of bindings with no ``activity_type``: the harness tells a
    device operation from a host one by its device, so a runtime launch
    reads as a host operation and is known by its name."""

    def activity_type(self):
        raise AttributeError("activity_type")

    def device_type(self):
        import torch

        device = self._v[1] in harness.DEVICE_KINDS or self._v[1] == "gpu_user_annotation"
        return torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[1] in ("user_annotation", "gpu_user_annotation")


@pytest.mark.parametrize("event", [_Event, _OldEvent])
def test_trace_of_finds_each_launch(event):
    """Device operations inside the window with their launch (runtime or
    driver event of the same correlation id), ``bench:`` ranges by label
    and ``tel:`` ranges by their full name; a host event that launches
    nothing does not stand in for a missing launch."""
    events, w0, wd = made_up_events()
    t = spans.trace_of([event(*e._v) for e in events], w0, wd)
    assert [o[0] for o in t.device_ops] == ["gemm", "eval_kernel", "memset"]
    assert t.launch[:2] == pytest.approx([0.031, 0.061]) and t.launch[2] is None
    assert {r[0] for r in t.ranges} >= {"window", "run(1)", "tel:cloud_round", "tel:page_in"}
    assert t.count("tel:cloud_round") == 1 and t.window_s == pytest.approx(0.1)


def _fake_profile(fn, host):
    assert host  # the spans pass records the host too
    return fn(), *made_up_events()


def _fake_work(cell, counters, tel):
    def work():
        tel.metrics.inc("made_up", 3)
    tel.metrics.inc("made_up", 1)  # set-up: not the window's
    return work


def test_pass_leaves_the_device_only_window_alone(monkeypatch):
    """The spans pass replaces the run's ``labelled`` window only: the
    device-only trace, the readers of the accepted metrics and the
    breakdown's device operations read as before, and the breakdown's idle
    gaps now name the program's spans instead of ``run(1)``."""
    cell = bench_smoke.cell(bench_smoke.FL_CELL)
    cell.device = "cuda"  # the pass runs on the card only; here a made-up one stands in for it
    SEG = "void segment_aggregate_kernel<float, long>(float const*, long const*, float const*, float*, long, long, long)"
    ops = [(SEG, 0.0, 0.25e-3), (SEG, 0.1, 0.25e-3), ("gemm", 0.2, 0.1)]
    old_labelled = harness.Trace(0.6, [("gemm", 0.1, 0.2)], [("window", 0.0, 0.6), ("run(1)", 0.0, 0.5)])
    trace = harness.Trace(0.5, list(ops), [], labelled=old_labelled)
    counters = {"cohort": 4096, "dim": 25141, "edges": 8, "traced_rounds": 2, "window_s": 2.0,
                "window_samples": 1_000_000}
    old = ("device_idle_pct.fl", "fl_mfu", "segment_aggregate_roofline")
    ctx = {"cell": cell, "trace": trace, "counters": counters}
    before = {n: _reader(n).read(ctx) for n in old}
    device_before = trace.breakdown()["device_ops"]
    assert dict(trace.breakdown()["idle_gaps"]).keys() == {"run(1)"}
    monkeypatch.setattr(spans, "_program_ranges", lambda: True)
    monkeypatch.setitem(spans.PASSES, "fl_stream", _fake_work)
    monkeypatch.setattr(harness, "_profile", _fake_profile)
    got = {n: _reader(n).read(ctx) for n in FL_NAMES}
    assert got == pytest.approx({"fl_idle_ms.assign": 20.0, "fl_idle_ms.page": 10.0, "fl_idle_ms.eval": 12.999,
                                 "fl_idle_ms.other": 22.0})
    assert trace.device_ops == ops and trace.labelled is ctx["spans"]
    assert ctx["spans"].counters == {"made_up": 3}
    assert {n: _reader(n).read(ctx) for n in old} == before
    assert trace.breakdown()["device_ops"] == device_before
    assert dict(trace.breakdown()["idle_gaps"]).keys() == {"tel:cohort_draw", "tel:eval"}


def test_no_pass_without_the_program_ranges_or_the_card(monkeypatch):
    """On the CPU, or with a program whose telemetry opens no profiler
    range (a parent without this instrumentation), no pass runs, every
    new reader gives no number and the run's labelled window stays."""
    calls = []
    monkeypatch.setitem(spans.PASSES, "fl_stream", lambda cell, c, tel: calls.append(cell))
    for device, ranges in (("cpu", True), ("cuda", False)):
        cell = bench_smoke.cell(bench_smoke.FL_CELL)
        cell.device = device
        monkeypatch.setattr(spans, "_program_ranges", lambda r=ranges: r)
        trace = harness.Trace(1.0, [], [])
        ctx = {"cell": cell, "trace": trace, "counters": {}}
        assert all(_reader(n).read(ctx) is None for n in FL_NAMES)
        assert trace.labelled is None
    assert calls == []


@pytest.mark.parametrize("name", [bench_smoke.FL_CELL, bench_smoke.LM_CELL])
def test_pass_work_on_the_smoke_cell(name):
    """The work the pass traces, on the CPU at smoke size with the
    program's telemetry on: the FL cell's ``traced_rounds`` rounds with the
    port's own spans in each, the LM cell's one cloud round of steps,
    which the program counts as ``sync_every`` steps' tokens and one sync
    (the set-up's warming steps counted before)."""
    from repro_torch.telemetry import Telemetry

    cell = bench_smoke.cell(name)
    tel = Telemetry()
    work = spans.PASSES[cell.traffic["driver"]](cell, {}, tel)
    before, mark = dict(tel.metrics.counters), len(tel.tracer.spans)
    work()
    names = [s.name for s in tel.tracer.spans[mark:]]
    counted = {k: v - before.get(k, 0) for k, v in tel.metrics.counters.items()}
    if name == bench_smoke.FL_CELL:
        for span in ("cloud_round", "cohort_draw", "batch_plan", "page_in", "eval"):
            assert names.count(span) == cell.traffic["traced_rounds"], span
        return
    every, c = cell.traffic["sync_every"], _ctx(name, None)["counters"]
    assert names.count("hfl_step") == every and names.count("cloud_avg") == 1
    assert names.count("adam") == every * c["edges"]
    assert counted == {"tokens_trained": every * c["edges"] * c["batch"] * c["seq"], "sync_steps": 1}
