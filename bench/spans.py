"""The program's own spans on the profiler's clock: the per-layer metrics
that split a cell's time by the port's layers read one more traced pass.

While a ``torch.profiler`` records, the port's telemetry opens a
``tel:<span>`` range with each of its wall spans (``repro_torch.telemetry``,
``RANGE_PREFIX``).  :func:`labelled` runs once per traced run, after the
measured and the traced windows and the check: it sets the cell's program
up again with its telemetry on (the FL engine through the driver's own
set-up; the LM replicas, steps and batches from the seed as the driver
draws them) and traces the driver's traced work (``traced_rounds``
rounds, or one cloud round of steps) on host and device.  The result, a
:class:`SpanTrace`, holds beside each device operation its launch on the
host (its runtime or driver launch event, found by the correlation id),
so an operation belongs to the span that was innermost-open when the host
launched it, and an idle stretch of the card to the span open while it
idled; and what the program's counters counted in the window.  It takes
the place of the ``labelled`` window of the run's trace, so the result
line's idle gaps name the program's spans; the device-only window and
every reading from it stay as they are.

A program whose telemetry opens no such range, or a run on the CPU, gets
no pass and its readers no number.  A pass that fails fails the run.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Callable, Dict, List, Optional

from bench import harness
from bench.gen import lm as gen_lm
from bench.gen import tokens as gen_tokens

TEL = "tel:"  # the program's ranges, as repro_torch.telemetry.trace.RANGE_PREFIX names them
# the host's runtime and driver API events, which carry their device
# operation's correlation id: by kind where the bindings tell it, else by
# name (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...)
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
LAUNCH_NAME = re.compile(r"cu(da)?[A-Z]")
UNMATCHED_MAX = 0.01  # most share of the device time whose launch may go unfound
# the FL round's layers as fl_idle_ms.<group> counts them; "other" is the rest
FL_GROUPS = {"assign": ("assignment", "cohort_draw", "batch_plan"), "page": ("page_in",), "eval": ("eval",)}


@dataclasses.dataclass
class SpanTrace(harness.Trace):
    """A window traced on host and device: the harness's ranges (by their
    label) and the program's (``tel:<span>``), and each device operation's
    launch on the host in seconds from the window's start (None where no
    launch event matched), parallel to ``device_ops``, and what the
    program's counters counted in the window."""

    launch: List[Optional[float]] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)

    def count(self, label: str) -> int:
        return sum(1 for lab, _, _ in self.ranges if lab == label)

    def unmatched_share(self) -> float:
        """Share of the device operations' time whose launch was not found."""
        total = sum(d for _, _, d in self.device_ops)
        lost = sum(d for (_, _, d), t in zip(self.device_ops, self.launch) if t is None)
        return lost / total if total > 0 else 1.0

    def _segments(self) -> tuple:
        """The window cut at every range's ends: (the cuts, the innermost
        range open in each piece)."""
        cuts = sorted({0.0, self.window_s} | {min(max(x, 0.0), self.window_s)
                                              for _, s, d in self.ranges for x in (s, s + d)})
        labels = [self.label_at(0.5 * (a + b)) for a, b in zip(cuts, cuts[1:])]
        return cuts, labels

    def idle_by_span(self) -> Dict[str, float]:
        """Seconds of the window in which no device operation ran, by the
        innermost range open then (each idle stretch split where ranges
        open and close, not put whole under the range open at its start)."""
        cuts, labels = self._segments()
        out: Dict[str, float] = {}
        for g0, gd in self.gaps():
            g1 = g0 + gd
            i = max(bisect.bisect_right(cuts, g0) - 1, 0)
            while i < len(labels) and cuts[i] < g1:
                piece = min(cuts[i + 1], g1) - max(cuts[i], g0)
                if piece > 0:
                    out[labels[i]] = out.get(labels[i], 0.0) + piece
                i += 1
        return out

    def busy_by_launch(self) -> Dict[str, float]:
        """Seconds the device was busy with the operations launched while
        each range was the innermost open one (the union of their
        intervals); operations with no launch found count under none."""
        by_label: Dict[str, list] = {}
        for (_, s, d), t in zip(self.device_ops, self.launch):
            if t is not None:
                by_label.setdefault(self.label_at(t), []).append((s, d))
        return {lab: harness.Trace(self.window_s, [("", s, d) for s, d in ops], []).busy_s()
                for lab, ops in by_label.items()}


def trace_of(events, w0: int, wd: int) -> SpanTrace:
    """The window [w0, w0 + wd) ns of a host-and-device profile: device
    operations with their launches, the harness's ranges (``bench:``
    stripped) and the program's (``tel:`` kept)."""
    launches: Dict[int, int] = {}
    device, ranges = [], []
    for e in events:
        kind = harness._kind(e)
        s, d = harness._ns(e)
        if kind in LAUNCH_KINDS or (kind == "cpu_op" and LAUNCH_NAME.match(e.name())):
            launches[e.correlation_id()] = s
        elif kind in harness.DEVICE_KINDS and s + d > w0 and s < w0 + wd:
            device.append((e, s, d))
        elif kind == "user_annotation":
            name = e.name()
            if name.startswith(harness.ANNOTATION):
                ranges.append((name[len(harness.ANNOTATION):], (s - w0) / 1e9, d / 1e9))
            elif name.startswith(TEL):
                ranges.append((name, (s - w0) / 1e9, d / 1e9))
    ops, launch = [], []
    for e, s, d in device:
        ops.append((e.name(), (s - w0) / 1e9, d / 1e9))
        t = launches.get(e.correlation_id())
        launch.append(None if t is None else (t - w0) / 1e9)
    return SpanTrace(wd / 1e9, ops, ranges, launch=launch)


# --- the pass ------------------------------------------------------------------
def _program_ranges() -> bool:
    """Whether the program's telemetry opens profiler ranges."""
    try:
        from repro_torch.telemetry.trace import RANGE_PREFIX
    except ImportError:
        return False
    return RANGE_PREFIX == TEL


def _fl_work(cell: harness.Cell, counters: dict, tel) -> Callable[[], object]:
    """``traced_rounds`` rounds of an engine set up by the driver (its
    checked rounds warm it), with ``tel`` as its telemetry."""
    eng, _, _, _, one_round, _ = harness.driver_of(cell).setup(cell)
    eng.tel = tel
    n = counters.get("traced_rounds", cell.traffic["traced_rounds"])
    return lambda: [one_round() for _ in range(n)]


def _lm_work(cell: harness.Cell, counters: dict, tel) -> Callable[[], object]:
    """One cloud round (``sync_every - 1`` local steps, one sync) of steps
    built with ``telemetry=tel`` over replicas and token batches drawn from
    the seed as the driver draws them; each step uploads its batch and
    ends in the host read of its loss, as the driver's do.  A local and a
    sync step run first, to warm the allocator."""
    import torch

    from repro_torch.distributed import init_hfl_state, make_hfl_train_step
    from repro_torch.training import adam

    cfg, tr, train = cell.config, cell.traffic, cell.config["training"]
    dev = torch.device(cell.device)
    opt = adam(train["lr"], b1=train["b1"], b2=train["b2"], eps=train["eps"])
    weights = gen_lm.init_weights(cell.seed, cfg, dev, getattr(torch, cfg["torch_dtype"]))
    held = [init_hfl_state(weights, opt, cfg["edges"])]
    del weights
    mc = harness.driver_of(cell).model_config(cfg)
    steps = {kind: make_hfl_train_step(mc, opt, sync=kind == "sync", grad_clip=train["clip"], telemetry=tel)
             for kind in ("local", "sync")}
    toks = torch.from_numpy(gen_tokens.edge_batches(cell.seed, cfg["edges"], tr["batch_steps"], tr["batch"],
                                                    tr["seq_len"], cfg["vocab_size"]))
    if dev.type == "cuda":
        toks = toks.pin_memory()
    fed = [0]

    def step(kind: str) -> float:
        t = toks[fed[0] % len(toks)].to(dev, non_blocking=True)
        fed[0] += 1
        held[0], metrics = steps[kind](held[0], {"tokens": t[..., :-1], "labels": t[..., 1:]})
        return float(metrics["total_loss"])

    step("local")
    step("sync")
    kinds = ["local"] * (tr["sync_every"] - 1) + ["sync"]
    return lambda: [step(k) for k in kinds]


PASSES = {"fl_stream": _fl_work, "hfl_train": _lm_work}


def run_pass(cell: harness.Cell, counters: dict) -> SpanTrace:
    """The cell's work (``PASSES``) with the program's telemetry on, traced
    on host and device; the trace keeps what the program's counters
    counted in it."""
    from repro_torch.telemetry import Telemetry

    tel = Telemetry()
    work = PASSES[cell.traffic["driver"]](cell, counters, tel)
    before = dict(tel.metrics.counters)
    _, events, w0, wd = harness._profile(work, host=True)
    trace = trace_of(events, w0, wd)
    trace.counters = {k: v - before.get(k, 0) for k, v in tel.metrics.counters.items()}
    return trace


def labelled(ctx: dict) -> Optional[SpanTrace]:
    """The spans pass of the run whose readers share ``ctx`` (run once,
    kept in ``ctx``); None where the program opens no ranges or the cell
    runs on the CPU.  A pass that fails fails the run.  The pass's trace
    takes the place of the run's ``labelled`` window, which the breakdown
    reads after every reader and no accepted reader reads."""
    if "spans" not in ctx:
        ctx["spans"] = None
        cell = ctx["cell"]
        if cell.traffic["driver"] in PASSES and cell.device != "cpu" and _program_ranges():
            harness.free_device(cell.device)
            ctx["spans"] = ctx["trace"].labelled = run_pass(cell, ctx["counters"])
            harness.free_device(cell.device)
    return ctx["spans"]


# --- what the readers read -----------------------------------------------------------
def fl_idle_ms(ctx: dict, group: str) -> Optional[float]:
    """Milliseconds a traced round in which the card idled while the
    innermost open span was one of ``group``'s (``FL_GROUPS``; "other":
    any other range, ``cloud_round``'s own time and the harness's loop)."""
    t = labelled(ctx)
    if t is None or t.unmatched_share() > UNMATCHED_MAX:
        return None
    needed = FL_GROUPS.get(group, ()) + ("cloud_round",)
    rounds = t.count(TEL + "cloud_round")
    if any(t.count(TEL + n) == 0 for n in needed):
        return None
    idle = t.idle_by_span()
    named = {TEL + n for names in FL_GROUPS.values() for n in names}
    if group == "other":
        secs = sum(v for k, v in idle.items() if k not in named)
    else:
        secs = sum(idle.get(TEL + n, 0.0) for n in FL_GROUPS[group])
    return 1e3 * secs / rounds


def lm_busy_ms(ctx: dict, span: str, per: str) -> Optional[float]:
    """Device-busy milliseconds of the operations launched while ``span``
    was the innermost open span, per step (``per="step"``: the program's
    ``tokens_trained`` over the cell's edges x batch x sequence) or per
    sync step (``per="sync"``: its ``sync_steps``)."""
    t = labelled(ctx)
    if t is None or t.unmatched_share() > UNMATCHED_MAX or t.count(TEL + span) == 0:
        return None
    c = ctx["counters"]
    n = (t.counters.get("tokens_trained", 0) / (c["edges"] * c["batch"] * c["seq"]) if per == "step"
         else t.counters.get("sync_steps", 0))
    if n == 0:
        return None
    return 1e3 * t.busy_by_launch().get(TEL + span, 0.0) / n
