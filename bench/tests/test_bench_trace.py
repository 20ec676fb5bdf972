"""The trace's arithmetic and the per-layer readers on made-up traces."""
from __future__ import annotations

import pytest

import bench_smoke
from bench import harness

SEG = "void segment_aggregate_kernel<float, long>(float const*, long const*, float const*, float*, long, long, long)"
AGG = "void aggregate_kernel<c10::BFloat16, 8>(c10::BFloat16 const*, float const*, c10::BFloat16*, long, long)"


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def test_busy_gaps_and_labels():
    t = harness.Trace(1.0, [("a", 0.1, 0.2), ("b", 0.2, 0.2), ("c", 0.6, 0.1)],
                      [("window", 0.0, 1.0), ("run(1)", 0.0, 0.5)])
    assert t.busy_s() == pytest.approx(0.4)
    assert [(round(s, 6), round(d, 6)) for s, d in t.gaps()] == [(0.0, 0.1), (0.4, 0.2), (0.7, 0.3)]
    bd = t.breakdown()
    assert dict(bd["idle_gaps"]) == pytest.approx({"run(1)": 0.3, "window": 0.3})
    assert bd["device_ops"][0][0] in ("a", "b")


def test_kernel_names_are_told_apart():
    seg, agg = _reader("segment_aggregate_roofline"), _reader("hier_aggregate_roofline")
    mangled_seg, mangled_agg = "_Z24segment_aggregate_kernelIflEvPKT_", "_Z16aggregate_kernelIfLi8EEvPKT_PKfPS0_ll"
    assert seg.NAME.search(SEG) and seg.NAME.search(mangled_seg)
    assert agg.NAME.search(AGG) and agg.NAME.search(mangled_agg)
    assert not agg.NAME.search(SEG) and not agg.NAME.search(mangled_seg)
    assert not seg.NAME.search(AGG)


def test_readers_on_a_made_up_fl_trace():
    cell = bench_smoke.cell(bench_smoke.FL_CELL)
    c = {"cohort": 4096, "dim": 25141, "edges": 8, "traced_rounds": 2, "window_s": 2.0, "window_samples": 1_000_000}
    trace = harness.Trace(0.5, [(SEG, 0.0, 0.25e-3), (SEG, 0.1, 0.25e-3), ("gemm", 0.2, 0.1)], [])
    ctx = {"cell": cell, "trace": trace, "counters": c}
    roof = _reader("segment_aggregate_roofline").read(ctx)
    assert roof == pytest.approx(100 * 411_910_144 / 3.35e12 / 0.25e-3, rel=1e-2)
    assert _reader("device_idle_pct.fl").read(ctx) == pytest.approx(100 * (1 - 0.1005 / 0.5))
    assert _reader("fl_mfu").read(ctx) == pytest.approx(100 * 946_272 * 1_000_000 / 2.0 / 67e12)
    c["traced_rounds"] = 3  # a launch missing from the trace: no reading rather than a wrong one
    assert _reader("segment_aggregate_roofline").read(ctx) is None


def test_readers_on_a_made_up_training_trace():
    cell = bench_smoke.cell(bench_smoke.LM_CELL)
    c = {"leaf_sizes": [100, 200], "edges": 5, "traced_syncs": 1, "sync_s": [0.6, 0.62], "local_s": [0.5, 0.5, 0.52],
         "steps": 10, "window_s": 5.0, "batch": 1, "seq": 32}
    trace = harness.Trace(1.0, [(AGG, 0.0, 1e-6), (AGG, 0.5, 1e-6), (SEG, 0.7, 1.0)], [])
    ctx = {"cell": cell, "trace": trace, "counters": c}
    cell.config["torch_dtype"] = "bfloat16"
    expect = 100 * (6 * 300 * 2 + 2 * 5 * 4) / 3.35e12 / 2e-6
    assert _reader("hier_aggregate_roofline").read(ctx) == pytest.approx(expect)
    assert _reader("hfl_sync_ms").read(ctx) == pytest.approx(110.0)
    assert _reader("train_mfu").read(ctx) > 0
