"""Span tracer: wall-clock + simulated-time tracks, JSONL and Chrome export.

A :class:`Tracer` records closed spans — named intervals with arbitrary
key/value attributes — on two tracks:

* ``wall``  : real host time (``time.perf_counter`` relative to the tracer
  epoch).  Opened with ``with tracer.span("cohort_epoch", round=r): ...``;
  nesting is tracked per thread so parent/child links survive concurrency.
* ``sim``   : simulated seconds (the async engine's ``EventQueue.now`` /
  the sync engine's :class:`~repro_torch.core.hfl.WallClock`).  Recorded after
  the fact via :meth:`Tracer.sim_span` since simulated intervals are known
  exactly, not measured.

Exports:

* :meth:`write_jsonl` — one span per line, lossless (sid/parent/attrs).
* :meth:`write_chrome_trace` — Chrome trace-event JSON (``"X"`` complete
  events, microsecond timestamps) loadable in Perfetto / chrome://tracing.
  Wall spans live under pid 1, simulated-time spans under pid 2, so the two
  time bases never share an axis.

Timing caveat: wall spans measure *host-side* time around device dispatch;
they do not force a synchronise (that would perturb the very pipeline
being observed).  Spans that contain an eval or a numpy conversion are
implicitly synchronised; pure-dispatch spans can under-report device time.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional


def _jsonable(v):
    """Best-effort conversion of attr values to JSON-safe scalars."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if hasattr(v, "item") and getattr(v, "ndim", None) in (0, None):
        try:
            return v.item()
        except Exception:  # pragma: no cover - exotic array types
            pass
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


@dataclasses.dataclass
class Span:
    """A closed interval on one track.  ``t0``/``t1`` are seconds."""

    name: str
    t0: float
    t1: float
    sid: int
    parent: Optional[int] = None
    tid: int = 0
    track: str = "wall"
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "dur": self.duration,
            "sid": self.sid,
            "parent": self.parent,
            "tid": self.tid,
            "track": self.track,
            "attrs": {k: _jsonable(v) for k, v in self.attrs.items()},
        }


class _SpanCtx:
    """Context manager for one in-flight wall span (one per ``span()`` call)."""

    __slots__ = ("_tracer", "name", "attrs", "sid", "parent", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.sid = -1
        self.parent: Optional[int] = None
        self._t0 = 0.0

    def set(self, **attrs) -> "_SpanCtx":
        """Attach attributes to the span while it is open."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanCtx":
        tr = self._tracer
        stack = tr._stack()
        self.sid = next(tr._ids)
        self.parent = stack[-1].sid if stack else None
        stack.append(self)
        self._t0 = tr.now()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        t1 = tr.now()
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tr._append(
            Span(self.name, self._t0, t1, self.sid, self.parent,
                 threading.get_ident() & 0xFFFF, "wall", self.attrs)
        )
        return False


class Tracer:
    """Thread-safe span recorder.  All public methods may be called from
    any thread; per-thread nesting stacks give correct parent links."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._epoch = time.perf_counter()
        self.spans: List[Span] = []

    # -- recording -----------------------------------------------------
    def now(self) -> float:
        """Wall seconds since this tracer was created."""
        return time.perf_counter() - self._epoch

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def _append(self, s: Span) -> None:
        with self._lock:
            self.spans.append(s)

    def span(self, name: str, **attrs) -> _SpanCtx:
        """Open a wall-clock span: ``with tracer.span("eval", round=r):``."""
        return _SpanCtx(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration wall event."""
        t = self.now()
        self._append(Span(name, t, t, next(self._ids), None,
                          threading.get_ident() & 0xFFFF, "wall", attrs))

    def sim_span(self, name: str, t0: float, t1: float, *, tid: int = 0,
                 **attrs) -> None:
        """Record a closed interval on the simulated-time track."""
        self._append(Span(name, float(t0), float(t1), next(self._ids),
                          None, tid, "sim", attrs))

    # -- queries -------------------------------------------------------
    def durations(self, name: str, track: str = "wall") -> List[float]:
        with self._lock:
            return [s.duration for s in self.spans
                    if s.name == name and s.track == track]

    def names(self) -> set:
        with self._lock:
            return {s.name for s in self.spans}

    # -- export --------------------------------------------------------
    def write_jsonl(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            rows = [s.to_dict() for s in self.spans]
        with path.open("w", encoding="utf-8") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        return path

    def chrome_events(self) -> List[dict]:
        """Spans as Chrome trace-event dicts (pid 1 wall, pid 2 simulated)."""
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "wall-clock"}},
            {"ph": "M", "name": "process_name", "pid": 2, "tid": 0,
             "args": {"name": "simulated-time"}},
        ]
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            events.append({
                "name": s.name,
                "cat": s.track,
                "ph": "X",
                "ts": s.t0 * 1e6,
                "dur": max(s.duration, 0.0) * 1e6,
                "pid": 1 if s.track == "wall" else 2,
                "tid": s.tid,
                "args": {k: _jsonable(v) for k, v in s.attrs.items()},
            })
        return events

    def write_chrome_trace(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"traceEvents": self.chrome_events(),
                   "displayTimeUnit": "ms"}
        path.write_text(json.dumps(payload), encoding="utf-8")
        return path


class _NullSpan:
    """Shared no-op context manager — the disabled-telemetry fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """API-compatible tracer that records nothing and allocates nothing."""

    def span(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def instant(self, name: str, **attrs) -> None:
        pass

    def sim_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        pass

    def durations(self, name: str, track: str = "wall") -> List[float]:
        return []

    def names(self) -> set:
        return set()


NULL_TRACER = NullTracer()
