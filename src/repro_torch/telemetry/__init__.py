"""Telemetry: span tracing, round metrics, analytic-cost hooks.

The port's copy of the reference's facade (``src/repro/telemetry``):

* ``tel.span("prefill", batch=b, ...)`` — wall-clock spans (nested,
  thread-safe) around the hot paths.
* ``tel.sim_span(...)`` — spans on a *simulated-time* track.
* ``tel.metrics`` — counters/gauges/histograms.
* ``tel.jit_cost(key, fn, *args)`` — the reference lowers a jitted program
  to HLO and counts its FLOPs and bytes; PyTorch runs eagerly and has no
  HLO, so here it returns ``None`` (ROADMAP.md Queue 1 item 9), and callers
  omit the cost, as the reference does when no cost is found.
* ``tel.on_round(...)`` — one record per round, exported as JSONL plus an
  end-of-run summary table.

Disabled telemetry is the :data:`NULL_TELEMETRY` singleton — every call
resolves to a shared no-op object.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.telemetry.metrics import (  # noqa: F401  (re-exports)
    MetricsRegistry,
    NULL_METRICS,
    jit_cache_sizes,
    register_jit,
    registered_jits,
)
from repro_torch.telemetry.report import CommDelta, summary_table, write_rounds_jsonl
from repro_torch.telemetry.trace import NULL_SPAN, NULL_TRACER, Tracer


class Telemetry:
    """Live telemetry sink: tracer + metrics + per-round records."""

    enabled = True

    def __init__(self, out_dir=None) -> None:
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()
        self.rounds: List[dict] = []
        self.out_dir: Optional[Path] = Path(out_dir) if out_dir else None
        self._span_mark = 0

    # -- tracing -------------------------------------------------------
    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def instant(self, name: str, **attrs) -> None:
        self.tracer.instant(name, **attrs)

    def sim_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        self.tracer.sim_span(name, t0, t1, **attrs)

    # -- analytic cost -------------------------------------------------
    def jit_cost(self, key: str, fn, *args, **kwargs) -> Optional[dict]:
        """Analytic FLOPs/bytes of ``fn(*args, **kwargs)``: not available.

        The reference reads them from the program's lowered HLO; an eager
        PyTorch program has none, so this returns ``None`` until the port
        counts them another way (ROADMAP.md Queue 1 item 9).
        """
        return None

    # -- round reporting ----------------------------------------------
    def _span_aggregate(self) -> dict:
        """Count/total-seconds per span name since the previous round."""
        with self.tracer._lock:
            fresh = self.tracer.spans[self._span_mark:]
            self._span_mark = len(self.tracer.spans)
        agg: Dict[str, dict] = {}
        for s in fresh:
            if s.track != "wall":
                continue
            a = agg.setdefault(s.name, {"count": 0, "total_s": 0.0})
            a["count"] += 1
            a["total_s"] += s.duration
        return agg

    def on_round(self, **fields) -> dict:
        rec = dict(fields)
        rec["spans"] = self._span_aggregate()
        rec["jit_cache_sizes"] = jit_cache_sizes()
        self.rounds.append(rec)
        return rec

    # -- finalisation --------------------------------------------------
    def summary(self) -> str:
        return summary_table(self.rounds)

    def flush(self, out_dir=None) -> Dict[str, Path]:
        """Write trace.json / trace.jsonl / rounds.jsonl / metrics.json /
        summary.txt under ``out_dir`` (or the constructor's).  Returns the
        written paths; empty dict when no output directory is configured."""
        out = Path(out_dir) if out_dir else self.out_dir
        if out is None:
            return {}
        out.mkdir(parents=True, exist_ok=True)
        paths = {
            "trace": self.tracer.write_chrome_trace(out / "trace.json"),
            "spans": self.tracer.write_jsonl(out / "trace.jsonl"),
            "rounds": write_rounds_jsonl(out / "rounds.jsonl", self.rounds),
        }
        m = out / "metrics.json"
        m.write_text(json.dumps(self.metrics.snapshot(), indent=2),
                     encoding="utf-8")
        paths["metrics"] = m
        s = out / "summary.txt"
        s.write_text(self.summary() + "\n", encoding="utf-8")
        paths["summary"] = s
        return paths


class _NullTelemetry:
    """Zero-overhead disabled telemetry (singleton)."""

    enabled = False
    tracer = NULL_TRACER
    metrics = NULL_METRICS
    rounds: List[dict] = []
    out_dir = None

    def span(self, name: str, **attrs):
        return NULL_SPAN

    def instant(self, name: str, **attrs) -> None:
        pass

    def sim_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        pass

    def jit_cost(self, key: str, fn, *args, **kwargs) -> None:
        return None

    def on_round(self, **fields) -> dict:
        return {}

    def summary(self) -> str:
        return "(telemetry disabled)"

    def flush(self, out_dir=None) -> Dict[str, Path]:
        return {}


NULL_TELEMETRY = _NullTelemetry()


def coerce_telemetry(t) -> Optional[Telemetry]:
    """Normalise the ``simulate(telemetry=...)`` knob.

    ``None``/``False`` → ``None`` (disabled); ``True`` → in-memory
    :class:`Telemetry`; a str/Path → :class:`Telemetry` flushing artifacts
    there; a :class:`Telemetry` (or the null singleton) passes through.
    """
    if t is None or t is False:
        return None
    if isinstance(t, Telemetry):
        return t
    if t is NULL_TELEMETRY:
        return None
    if t is True:
        return Telemetry()
    if isinstance(t, (str, Path)):
        return Telemetry(out_dir=t)
    raise TypeError(f"telemetry must be None/bool/path/Telemetry, got {type(t)!r}")


__all__ = [
    "Telemetry",
    "NULL_TELEMETRY",
    "coerce_telemetry",
    "Tracer",
    "MetricsRegistry",
    "CommDelta",
    "register_jit",
    "jit_cache_sizes",
    "registered_jits",
    "summary_table",
    "write_rounds_jsonl",
]
