"""Metrics registry: counters, gauges, histograms, and jit-compile counts.

The registry is deliberately tiny — a dict of floats per kind — because the
hot paths touch it per cohort / per upload, and anything heavier would show
up in the very benchmarks it instruments.  Histograms keep running moments
(count/sum/sum-of-squares/min/max) plus a bounded sample reservoir for
percentiles.

Jit-compile accounting: engine modules call :func:`register_jit` at import
time for each module-level ``jax.jit`` function.  :func:`jit_cache_sizes`
reads each function's compiled-program cache size (``_cache_size()``), so a
before/after delta counts *actual XLA compilations* — the compile-count
regression guard in ``tests/test_telemetry.py`` pins these deltas to lock
in the tiny-N ``flat_mean`` recompile fix.

(A stdlib-only copy of the reference's ``telemetry/metrics.py``.  The port
runs eagerly and compiles nothing per shape, so no module registers a
function and :func:`jit_cache_sizes` is empty; every round record still
carries it, as the reference's consumers expect.  The port's reading of
the same question, what a round put on the device, is the per-round
``kernel_launches`` of ``Telemetry.on_round``.)
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

_MAX_SAMPLES = 65536


class Histogram:
    """Streaming histogram: running moments + bounded raw samples."""

    __slots__ = ("count", "total", "sumsq", "mn", "mx", "samples")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.sumsq = 0.0
        self.mn = math.inf
        self.mx = -math.inf
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.sumsq += v * v
        self.mn = min(self.mn, v)
        self.mx = max(self.mx, v)
        if len(self.samples) < _MAX_SAMPLES:
            self.samples.append(v)

    def _percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[i]

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        mean = self.total / self.count
        var = max(self.sumsq / self.count - mean * mean, 0.0)
        return {
            "count": self.count,
            "mean": mean,
            "std": math.sqrt(var),
            "min": self.mn,
            "max": self.mx,
            "p50": self._percentile(0.50),
            "p95": self._percentile(0.95),
        }


class MetricsRegistry:
    """Named counters (monotone), gauges (last value), histograms."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}

    def inc(self, name: str, v: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(v)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauges[name] = float(v)

    def observe(self, name: str, v: float) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.observe(v)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.summary() for k, h in self.hists.items()},
        }


class NullMetrics:
    """No-op registry used by disabled telemetry."""

    def inc(self, name: str, v: float = 1.0) -> None:
        pass

    def set_gauge(self, name: str, v: float) -> None:
        pass

    def observe(self, name: str, v: float) -> None:
        pass

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = NullMetrics()

# ---------------------------------------------------------------------------
# jit compile accounting
# ---------------------------------------------------------------------------

_JITS: Dict[str, Callable] = {}


def register_jit(name: str, fn: Callable) -> Callable:
    """Register a module-level jitted function for compile counting.

    Idempotent per name; returns ``fn`` so it can wrap a definition.
    """
    _JITS[name] = fn
    return fn


def jit_cache_sizes() -> Dict[str, int]:
    """Compiled-program cache size per registered jit function.

    A function absent from the result does not expose ``_cache_size`` under
    the running jax version (the accounting degrades gracefully).
    """
    out: Dict[str, int] = {}
    for name, fn in _JITS.items():
        try:
            out[name] = int(fn._cache_size())
        except Exception:  # pragma: no cover - jax-version dependent
            continue
    return out


def registered_jits() -> Dict[str, Callable]:
    return dict(_JITS)
