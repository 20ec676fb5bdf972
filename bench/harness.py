"""What every cell shares: the cell's files, the window's clock, the
device trace and the result line.

Cells are data.  ``BENCHMARK.json`` names each cell's configuration and
traffic; ``bench/configs/<config>.json`` holds the configuration as it
runs, ``bench/traffic/<traffic>.json`` the driver that runs it and its
parameters, ``bench/limits/<cell>.json`` the limits of the comparison
that decides ``correct``, and ``bench/metrics/<metric>.py`` one reader per
per-layer metric.  The harness finds each by name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
ANNOTATION = "bench:"  # prefix of the harness's own record_function ranges
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    """One run of one cell: its entry and files, and the run's arguments."""

    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def chips(self) -> int:
        return int(self.entry.get("chips", 1))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT, device: str = "cuda",
              t0: Optional[float] = None) -> Cell:
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    bench_dir = root / "bench"
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{name}.json")
    cell = Cell(name, entry, config, traffic, limits, int(seed), float(seconds), bool(trace), device)
    if t0 is not None:
        cell.t0 = t0
    return cell


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, by path (metric files carry
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_of(cell: Cell, root: Path = ROOT):
    drv = cell.traffic["driver"]
    return load_module(root / "bench" / "drivers" / f"{drv}.py", f"bench_driver_{drv}")


def metrics_for(cell: Cell, kind: str, root: Path = ROOT) -> List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those that list
    it, or, without a list, those whose end-to-end metric it reports."""
    bench = benchmark(root)
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell.name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m else m["moves"] in names)]


# --- the window's clock ------------------------------------------------------
def p95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = 0.95 * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: List[float]) -> float:
    return float(statistics.median(values))


# --- the device trace --------------------------------------------------------
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """A traced window: device operations and the harness's host ranges,
    in seconds from the window's start."""

    window_s: float
    device_ops: List[tuple]  # (name, start_s, dur_s)
    ranges: List[tuple]  # (label, start_s, dur_s)
    labelled: Optional["Trace"] = None  # a second window traced on the host too, for the idle gaps' labels

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        total, end = 0.0, -math.inf
        for _, s, d in sorted(self.device_ops, key=lambda o: o[1]):
            e = s + d
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    def idle_pct(self) -> Optional[float]:
        """Percent of the window in which no device operation ran (None
        for a window that holds none)."""
        if self.window_s <= 0 or not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def op_seconds(self, match: Callable[[str], bool]) -> tuple:
        """(count, seconds) of the device operations whose name matches."""
        hits = [d for n, _, d in self.device_ops if match(n)]
        return len(hits), float(sum(hits))

    def gaps(self) -> List[tuple]:
        """(start_s, dur_s) of every stretch of the window with no device
        operation running."""
        out, end = [], 0.0
        for _, s, d in sorted(self.device_ops, key=lambda o: o[1]):
            if s > end:
                out.append((end, s - end))
            end = max(end, s + d)
        if self.window_s > end:
            out.append((end, self.window_s - end))
        return out

    def label_at(self, t: float) -> str:
        """The innermost harness range open on the host at ``t``."""
        best, best_dur = "outside any range", math.inf
        for label, s, d in self.ranges:
            if s <= t < s + d and d < best_dur:
                best, best_dur = label, d
        return best

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the harness's host range it fell in (from ``labelled`` when given)."""
        by_op: Dict[str, float] = {}
        for n, _, d in self.device_ops:
            by_op[n] = by_op.get(n, 0.0) + d
        by_label: Dict[str, float] = {}
        gaps = self.labelled or self
        for s, d in gaps.gaps():
            lab = gaps.label_at(s)
            by_label[lab] = by_label.get(lab, 0.0) + d
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _kind(e) -> str:
    try:
        return str(e.activity_type())
    except AttributeError:  # older kineto bindings
        import torch

        if e.device_type() == torch.autograd.DeviceType.CUDA:
            return "gpu_user_annotation" if e.is_user_annotation() else "kernel"
        return "user_annotation" if e.is_user_annotation() else "cpu_op"


def _ns(e) -> tuple:
    try:
        return e.start_ns(), e.duration_ns()
    except AttributeError:
        return e.start_us() * 1000, e.duration_us() * 1000


def _profile(fn: Callable[[], object], host: bool) -> tuple:
    """``fn`` under ``torch.profiler``, the card synchronised on both sides;
    returns (fn's value, the kineto events, the window's start and length
    in ns).  With ``host`` the host's operations and the harness's ranges
    are recorded too; without, a marker launched on each side of ``fn``
    bounds the window on the device's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    marker = torch.zeros(1, device="cuda")
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(ANNOTATION + "window"):
            marker.add_(1)
            out = fn()
            torch.cuda.synchronize()
            marker.add_(1)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    if host:
        window = [e for e in events if e.name() == ANNOTATION + "window" and _kind(e) == "user_annotation"]
        w0, wd = _ns(window[0])
    else:
        spans = sorted(_ns(e) for e in events if _kind(e) in DEVICE_KINDS)
        w0 = spans[0][0]
        wd = max(s + d for s, d in spans) - w0
    return out, events, w0, wd


def _trace_of(events, w0: int, wd: int) -> "Trace":
    ops, ranges = [], []
    for e in events:
        kind = _kind(e)
        s, d = _ns(e)
        if kind in DEVICE_KINDS and s + d > w0 and s < w0 + wd:
            ops.append((e.name(), (s - w0) / 1e9, d / 1e9))
        elif kind == "user_annotation" and e.name().startswith(ANNOTATION):
            ranges.append((e.name()[len(ANNOTATION):], (s - w0) / 1e9, d / 1e9))
    return Trace(wd / 1e9, ops, ranges)


def traced(fn: Callable[[], object]) -> tuple:
    """Run ``fn`` twice under the profiler: once tracing the device alone
    (the busy and idle time, the kernels' times: recording every host
    operation would slow the host and show idle time the untraced run does
    not have), then tracing host and device, whose idle gaps the harness's
    host ranges label.  Returns (fn's first value, ``Trace``)."""
    out, events, w0, wd = _profile(fn, host=False)
    trace = _trace_of(events, w0, wd)
    _, events, w0, wd = _profile(fn, host=True)
    trace.labelled = _trace_of(events, w0, wd)
    return out, trace


def record(label: str):
    """A host range the trace's idle gaps are labelled by."""
    import torch

    return torch.profiler.record_function(ANNOTATION + label)


# --- the device --------------------------------------------------------------
def free_device(device: str) -> None:
    """Return what the program held to the card before the reference runs."""
    import gc

    gc.collect()
    if device != "cpu":
        import torch

        torch.cuda.empty_cache()


def require_chips(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} CUDA devices, torch sees {torch.cuda.device_count()}")


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def device_info(chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


# --- the comparison that decides ``correct`` ------------------------------------
def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": float(value), "limit": float(limit)}


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """Every number the cell's limits name, beside its limit."""
    return [check(k, readings[k], v) for k, v in limits.items()]


def passes(c: dict) -> bool:
    return math.isfinite(c["value"]) and c["value"] <= c["limit"]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: Optional[Dict[str, bool]] = None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's (inf where the program's is not finite)."""
    names = [k for k in ref if keep is None or keep[k]]
    med = median([ref[k] for k in names])
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names]
    return max(g if math.isfinite(g) else math.inf for g in gaps)
