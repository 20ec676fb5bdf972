"""Metrics registry: counters, gauges, histograms.

The registry is deliberately tiny — a dict of floats per kind — because the
hot paths touch it per cohort / per upload, and anything heavier would show
up in the very benchmarks it instruments.  Histograms keep running moments
(count/sum/sum-of-squares/min/max) plus a bounded sample reservoir for
percentiles.

(A stdlib-only copy of the reference's ``telemetry/metrics.py``, less its
jit-compile accounting: the port runs eagerly and compiles nothing per
shape.  The port's reading of what a round put on the device is the
per-round ``kernel_launches`` of ``Telemetry.on_round``.)
"""
from __future__ import annotations

import math
from typing import Dict, List

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
