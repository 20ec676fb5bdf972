"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the last line of standard output is the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
traced window after the measured one, with the trace's breakdown.  Both
check the program's first steps against the plain reference and print
each number compared beside its limit, last on standard error and last
in the result line.  Without the CUDA devices the cell asks for, or with
JAX or the JAX package loaded, the run prints no result and exits 1.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    single-threaded numeric libraries; the program's own sources first on
    the path."""
    build = ROOT / "build"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"  # one process, few threads: the host's share of a run steadier
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def execute(cell) -> dict:
    """The cell's driver, then the per-layer readers on a traced run.
    Returns the result line as a dict; the comparisons go last."""
    from bench import harness

    out = harness.driver_of(cell).run(cell)
    trace = out["trace"]
    if cell.trace:
        metrics = {}
        ctx = {"cell": cell, "trace": trace, "counters": out["counters"]}
        for m in harness.metrics_for(cell, "per_layer"):
            reader = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py",
                                         "bench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in harness.metrics_for(cell, "end_to_end")}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in out["e2e"].items() if k in units}
    checks = out["checks"]
    result = {
        "correct": all(harness.passes(c) for c in checks) and out["failed"] == 0,
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": harness.device_info(cell.chips, out["peak_bytes"]) if cell.device != "cpu" else
        {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0},
    }
    if cell.trace:
        result["device"].update({"busy_s": trace.busy_s(), "window_s": trace.window_s,
                                 "power_limit_w": harness.power_limit_w()})
        result["breakdown"] = trace.breakdown()
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from bench import harness

    cell = harness.load_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    try:
        harness.require_chips(cell.chips)
    except SystemExit as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    result = execute(cell)
    found = harness.forbidden_loaded()
    if found:
        print(f"bench: JAX or the JAX package was loaded in this process: {found}", file=sys.stderr)
        return 1
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
