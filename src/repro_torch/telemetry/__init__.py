"""Telemetry: span tracing, round metrics, analytic-cost hooks.

The port's copy of the reference's facade (``src/repro/telemetry``):

* ``tel.span("prefill", batch=b, ...)`` — wall-clock spans (nested,
  thread-safe) around the hot paths; while a ``torch.profiler`` records,
  each is also a ``tel:<name>`` range in its trace, so the device time
  under a span is read there (see ``telemetry/trace.py``).
* ``tel.sim_span(...)`` — spans on a *simulated-time* track.
* ``tel.metrics`` — counters/gauges/histograms.
* ``tel.jit_cost(key, fn, *args)`` — analytic FLOPs and bytes of one
  program, cached per (key, argument shapes): the reference lowers a jitted
  program to HLO; an eager program has no HLO, so here ``fn`` runs once on
  ``meta`` copies of its tensor arguments (shapes only: no data, no
  kernel launch, no generator draw) under ``torch.utils.flop_counter``,
  with a byte counter beside it (see :meth:`Telemetry.jit_cost`).
* ``tel.on_round(...)`` — one record per round, exported as JSONL plus an
  end-of-run summary table.  The reference's fields, less its
  ``jit_cache_sizes`` (the port compiles no program per shape); beside
  them each record carries ``kernel_launches``: the launches of each CUDA
  kernel of the port since the previous record (also the gauges
  ``kernel_launches/<kernel>``), the port's reading of what a round put on
  the card.

Disabled telemetry is the :data:`NULL_TELEMETRY` singleton — every call
resolves to a shared no-op object, so instrumented code pays one attribute
lookup and nothing else.  Telemetry never makes the host wait for the card:
a device scalar is observed through :meth:`Telemetry.observe_later`, which
reads it at the next ``on_round``, after the round's eval.

User-facing knob: ``simulate(telemetry=...)`` accepts ``True``
(in-memory), a directory path (artifacts written on flush), or a
:class:`Telemetry` instance.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.telemetry.metrics import MetricsRegistry, NULL_METRICS  # noqa: F401  (re-exports)
from repro_torch.telemetry.report import CommDelta, summary_table, write_rounds_jsonl
from repro_torch.telemetry.trace import NULL_SPAN, NULL_TRACER, RANGE_PREFIX, Tracer


def _arg_key(a):
    """Hashable cache key for one ``jit_cost`` argument: tensors (and numpy
    arrays) collapse to (shape, dtype), what the reference's jit caches on."""
    if hasattr(a, "shape") and hasattr(a, "dtype"):
        return ("arr", tuple(a.shape), str(a.dtype))
    if isinstance(a, (tuple, list)):
        return ("seq", tuple(_arg_key(x) for x in a))
    if isinstance(a, dict):
        return ("map", tuple(sorted((str(k), _arg_key(v)) for k, v in a.items())))
    try:
        hash(a)
        return a
    except TypeError:
        return ("type", type(a).__name__)


def step_loop(resize):
    """Declare a function a loop of identical steps, for ``jit_cost``.

    ``resize(k, args, kwargs) -> (n, args_k, kwargs_k)`` returns the call's
    own step count ``n`` and its arguments cut to ``k`` steps.  ``jit_cost``
    then counts the 1- and 2-step programs and extrapolates to ``n``
    (exact for a program whose cost is affine in its steps), where the
    reference's lowered ``scan`` counts its body once times its trip
    count: counting all ``n`` steps of a 128-step epoch would cost seconds
    of host time.
    """

    def mark(fn):
        fn.cost_steps = resize
        return fn

    return mark


def client_map(cut):
    """Declare a function a map over C independent clients, for ``jit_cost``.

    ``cut(args, kwargs)`` returns None when the call runs one batched form
    (counted as it runs), else ``(c, args_1, kwargs_1)``: the call's client
    count and its arguments cut to one client.  ``jit_cost`` then counts the
    one-client program and scales by C.  A mapped program counted whole
    over-counts: torch's flop formula for a convolution's backward ignores
    the groups ``torch.func.vmap`` gives a mapped convolution.
    """

    def mark(fn):
        fn.cost_clients = cut
        return fn

    return mark


def _to_meta(a):
    """``a`` with every tensor in it replaced by a ``meta`` tensor of the
    same shape, strides and dtype (tuples, lists and dicts walked)."""
    import torch

    if _is_dtensor(a):
        return _dtensor_to_meta(a)
    if isinstance(a, torch.Tensor):
        return torch.empty_strided(a.size(), a.stride(), dtype=a.dtype, device="meta")
    if isinstance(a, tuple) and hasattr(a, "_fields"):  # a NamedTuple (the train step's state)
        return type(a)(*(_to_meta(x) for x in a))
    if isinstance(a, (tuple, list)):
        return type(a)(_to_meta(x) for x in a)
    if isinstance(a, dict):
        return {k: _to_meta(v) for k, v in a.items()}
    return a


def _is_dtensor(a) -> bool:
    from repro_torch.distributed.axes import is_dtensor

    return is_dtensor(a)


def _dtensor_to_meta(a):
    """A DTensor with fake shards (the dry run's) as it is; any other with
    meta shards of the same shapes, placements and mesh."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor

    local = a.to_local()
    if is_fake(local):
        return a
    meta = torch.empty_strided(local.size(), local.stride(), dtype=local.dtype, device="meta")
    return DTensor.from_local(meta, a.device_mesh, a.placements, run_check=False, shape=a.shape, stride=a.stride())


def _has_tensor(a) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return True
    if isinstance(a, (tuple, list)):
        return any(_has_tensor(x) for x in a)
    if isinstance(a, dict):
        return any(_has_tensor(v) for v in a.values())
    return False


def _any_dtensor(a) -> bool:
    if _is_dtensor(a):
        return True
    if isinstance(a, (tuple, list)):
        return any(_any_dtensor(x) for x in a)
    if isinstance(a, dict):
        return any(_any_dtensor(v) for v in a.values())
    return False


def _byte_counter():
    """A dispatch mode that adds up the bytes every operation writes (each
    output of an operation that is not a view), the eager stand-in for
    ``hlo_stats``' bytes of materializing ops."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0
            self._views = {}

        def _is_view(self, func) -> bool:
            v = self._views.get(func)
            if v is None:
                v = self._views[func] = any(
                    r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns
                )
            return v

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not self._is_view(func):
                for t in tree_flatten(out)[0]:
                    if hasattr(t, "element_size"):
                        self.total += t.numel() * t.element_size()
            return out

    return ByteCounter()


def _local_counter():
    """The two counters of :func:`_count` as one dispatch mode that lets
    every DTensor operation through to DTensor's own dispatch first, so it
    counts each rank's local operations (its shards' FLOPs and bytes, the
    per-rank cost of a sharded program)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    import torch

    flops = FlopCounterMode(display=False)
    nbytes = _byte_counter()

    class LocalCounter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func not in flops.flop_registry and func is not torch.ops.prim.device.default:
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if func._overloadpacket in flops.flop_registry:
                try:
                    flops._count_flops(func._overloadpacket, out, args, kwargs)
                except TypeError:  # a formula without an overload's extra arguments (bmm.dtype's out_dtype)
                    tensors = tuple(a for a in args if isinstance(a, torch.Tensor))
                    flops._count_flops(func._overloadpacket, out, tensors, {})
            if not nbytes._is_view(func):
                for t in tree_flatten(out)[0]:
                    if hasattr(t, "element_size"):
                        nbytes.total += t.numel() * t.element_size()
            return out

    return LocalCounter(), flops, nbytes


def _count(fn, args, kwargs) -> dict:
    """FLOPs (``FlopCounterMode``: matrix products and convolutions, forward
    and backward) and bytes written of one call on meta tensors; on
    DTensors, those of this rank's shards (:func:`_local_counter`)."""
    from torch.utils.flop_counter import FlopCounterMode

    if _any_dtensor((args, kwargs)):
        mode, flops, nbytes = _local_counter()
        with mode:
            fn(*args, **kwargs)
        return {"flops": float(flops.get_total_flops()), "bytes_moved": float(nbytes.total)}

    nbytes = _byte_counter()
    flops = FlopCounterMode(display=False)
    # the flop counter innermost: it sees each call first and decomposes
    # what it has no formula for, so the byte counter sees what would run
    with nbytes, flops:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()), "bytes_moved": float(nbytes.total)}


def analytic_cost(fn, args, kwargs) -> dict:
    """The analytic cost of ``fn(*args, **kwargs)`` counted on meta copies
    of its tensors; a ``step_loop`` function is counted at 1 and 2 steps
    and extrapolated to its own step count, and a mapped ``client_map``
    call is counted at one client and scaled by its client count."""
    args, kwargs = _to_meta(tuple(args)), _to_meta(dict(kwargs))
    clients = 1
    cut = getattr(fn, "cost_clients", None)
    one = cut(args, kwargs) if cut is not None else None
    if one is not None:
        clients, args, kwargs = one
    cost = _steps_cost(fn, args, kwargs)
    return {k: v * clients for k, v in cost.items()}


def _steps_cost(fn, args, kwargs) -> dict:
    resize = getattr(fn, "cost_steps", None)
    if resize is not None:
        n, a1, k1 = resize(1, args, kwargs)
        if n > 2:
            _, a2, k2 = resize(2, args, kwargs)
            c1, c2 = _count(fn, a1, k1), _count(fn, a2, k2)
            return {k: c1[k] + (n - 1) * (c2[k] - c1[k]) for k in c1}
    return _count(fn, args, kwargs)


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import launch_counts

    return launch_counts()


class Telemetry:
    """Live telemetry sink: tracer + metrics + per-round records."""

    enabled = True

    def __init__(self, out_dir=None) -> None:
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()
        self.rounds: List[dict] = []
        self.out_dir: Optional[Path] = Path(out_dir) if out_dir else None
        self._cost_cache: Dict[tuple, dict] = {}
        self._span_mark = 0
        self._later: List[tuple] = []
        self._launch_mark = _launch_counts()

    # -- tracing -------------------------------------------------------
    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def sim_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        self.tracer.sim_span(name, t0, t1, **attrs)

    # -- analytic cost -------------------------------------------------
    def jit_cost(self, key: str, fn, *args, **kwargs) -> Optional[dict]:
        """FLOPs/bytes_moved of ``fn(*args, **kwargs)``, counted without
        running it on the data.

        ``fn`` runs once on ``meta`` copies of its tensor arguments (a meta
        tensor has a shape and no storage: the kernels' wrappers send it to
        their plain versions, so nothing is launched, counted as a launch
        or drawn from a generator) under ``FlopCounterMode`` and a byte
        counter.  FLOPs are those of the matrix products and convolutions,
        forward and backward, as the reference's ``hlo_stats`` counts its
        dots; ``bytes_moved`` adds up every operation's output, where the
        reference counts only what XLA's fusion leaves in memory, so it is
        larger (eager execution materializes every intermediate).  A
        ``step_loop`` function is counted at 1 and 2 steps and extrapolated,
        and a mapped ``client_map`` call at one client, scaled by C.

        Results are cached on (key, argument shapes/dtypes, other
        arguments), so later calls are dict lookups, and set the gauges
        ``analytic_flops/<key>`` and ``analytic_bytes/<key>``.  Returns
        ``None`` when the program cannot be analysed: it raises on meta
        tensors, or it is given no tensor to count on.  A program that
        writes into its arguments (the serving engine's decode step
        advances its cache; the train step updates its parameters) writes
        into the meta copies only.
        """
        ck = (key, tuple(_arg_key(a) for a in args),
              tuple(sorted((k, _arg_key(v)) for k, v in kwargs.items())))
        hit = self._cost_cache.get(ck)
        if hit is None:
            hit = self._analyze(key, fn, args, kwargs)
            self._cost_cache[ck] = hit
        return hit or None

    def _analyze(self, key: str, fn, args, kwargs) -> dict:
        if not _has_tensor((args, kwargs)):
            return {}
        try:
            cost = analytic_cost(fn, args, kwargs)
        except Exception:
            return {}
        self.metrics.set_gauge(f"analytic_flops/{key}", cost["flops"])
        self.metrics.set_gauge(f"analytic_bytes/{key}", cost["bytes_moved"])
        return cost

    def observe_later(self, name: str, value) -> None:
        """Observe ``value`` (a 0-d device tensor) into histogram ``name``
        at the next :meth:`on_round`, after the round's eval, where the
        host waits for the card anyway, instead of making it wait now."""
        self._later.append((name, value))

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

    def _launches(self) -> Dict[str, int]:
        """Each kernel's launches since the previous call (a counter reset
        in between counts from zero)."""
        cur = _launch_counts()
        mark = self._launch_mark
        self._launch_mark = cur
        return {k: v - mark.get(k, 0) if v >= mark.get(k, 0) else v for k, v in cur.items()}

    def on_round(self, **fields) -> dict:
        for name, value in self._later:
            self.metrics.observe(name, float(value))
        self._later = []
        rec = dict(fields)
        rec["spans"] = self._span_aggregate()
        rec["kernel_launches"] = self._launches()
        for k, v in rec["kernel_launches"].items():
            self.metrics.set_gauge(f"kernel_launches/{k}", v)
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

    def sim_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        pass

    def jit_cost(self, key: str, fn, *args, **kwargs) -> None:
        return None

    def observe_later(self, name: str, value) -> None:
        pass

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
    "RANGE_PREFIX",
    "step_loop",
    "client_map",
    "summary_table",
    "write_rounds_jsonl",
]
