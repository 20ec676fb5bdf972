"""Seeded fault model: churn, energy budgets, and time-varying channels.

The model is split in two:

* :class:`FaultSpec` — a frozen, validated description of the failure
  behaviour.  Everything it induces is a pure function of ``(spec.seed,
  stream, indices)``: the availability trace, the per-attempt upload-failure
  draws, the Rayleigh re-fades and the slow channel drift all come from
  independently *keyed* ``numpy`` generators, NEVER from the engines' own
  RNG stream.  That keeps two invariants: (1) the engines' draw-for-draw RNG
  parity (participation + batch draws) is untouched, so ``faults=None`` runs
  stay bit-identical to the fault-free engines; (2) the churn/failure
  schedule is identical across reference / sync-device / sync-host / async
  for one spec, whatever each engine's internal draw order is.

* :class:`FaultState` — the mutable per-run runtime built from a spec plus
  the scenario's physical layer (``wireless.channel``, evaluated on the
  run's ``device``).  It re-evaluates the cost matrices at each round's
  faded channel, tracks per-EU energy budgets debited through the paper's
  eq. 16 energy model, answers membership questions (``participation``),
  and plans the async engine's retry-with-backoff upload cascades
  (:meth:`plan_upload`).

Availability is a two-state Markov chain stepped once per CLOUD round: an
"up" EU goes down with ``p_drop``, a "down" EU rejoins with ``p_rejoin``.
Mid-round losses (``p_fail``) model uploads that die in the air after local
training already happened — the sync engines mask those rows out of the
aggregation; the async engine retries them with exponential backoff.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.wireless.channel import (
    CostMatrices,
    Topology,
    WirelessParams,
    build_cost_matrices,
)

# stream codes for the keyed generators (stable across releases: changing
# one renumbers every derived schedule)
_AVAIL, _FAIL, _FADE, _DRIFT, _ENERGY = 1, 2, 3, 4, 5


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Reproducible fault description (see module docstring).

    * churn — ``p_drop`` / ``p_rejoin`` step the per-EU availability Markov
      chain once per cloud round; ``start_up`` is the probability an EU
      begins the run available.
    * mid-round losses — each upload transmission is independently lost
      with ``p_fail``.  The async engine retries a lost transmission up to
      ``max_retries`` times with ``backoff_s * 2**attempt`` spacing and
      abandons the EU for the round past ``timeout_s`` (``None`` = no
      deadline); the sync engines have no retry channel, so a lost upload
      is simply masked out of that round's aggregation.
    * energy — ``energy_uploads`` grants each EU a battery budget expressed
      in units of the round-1 mean feasible upload energy (eq. 16), spread
      uniformly by ``±energy_spread`` relative; every attempted upload
      debits the actual per-edge energy and an EU whose budget hits zero
      stops participating.  ``None`` = infinite budgets.
    * channel dynamics — Rayleigh fading is re-drawn every
      ``refade_rounds`` cloud rounds (0 = keep the topology's static fade)
      and multiplied by a slow per-pair log-normal random walk of scale
      ``drift_rate``.
    * ``reassign`` — when drift invalidates an EU's feasible-edge set, the
      EARA assignment is incrementally re-repaired at the next cloud round
      (``core.assignment.repair_assignment``).
    """

    seed: int = 0
    # availability churn
    p_drop: float = 0.2
    p_rejoin: float = 0.5
    start_up: float = 1.0
    # mid-round upload losses / async retry policy
    p_fail: float = 0.0
    max_retries: int = 2
    backoff_s: float = 0.25
    timeout_s: Optional[float] = None
    # energy budgets
    energy_uploads: Optional[float] = None
    energy_spread: float = 0.0
    # channel dynamics
    refade_rounds: int = 1
    drift_rate: float = 0.0
    # assignment re-repair
    reassign: bool = False

    def __post_init__(self):
        for name in ("p_drop", "p_rejoin", "start_up", "p_fail"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {self.timeout_s}")
        if self.energy_uploads is not None and self.energy_uploads <= 0:
            raise ValueError(
                f"energy_uploads must be positive, got {self.energy_uploads}"
            )
        if not (0.0 <= self.energy_spread < 1.0):
            raise ValueError(
                f"energy_spread must be in [0, 1), got {self.energy_spread}"
            )
        if self.refade_rounds < 0:
            raise ValueError(f"refade_rounds must be >= 0, got {self.refade_rounds}")
        if self.drift_rate < 0:
            raise ValueError(f"drift_rate must be >= 0, got {self.drift_rate}")


@dataclasses.dataclass
class UploadPlan:
    """Outcome of one (EU, edge) upload cascade, resolved at dispatch time.

    All failure draws are keyed by (round, EU, edge, dispatch#, attempt), so
    the whole retry cascade is known when the transmission starts; the async
    engine turns the plan into one future "upload" or "lost" event.  Times
    are relative to the dispatch instant.
    """

    ok: bool
    t_end: float  # delivery time if ok, else when the edge gives the EU up
    windows: List[Tuple[float, float, int]]  # (start, end, attempt) airtime
    reason: str = ""  # "" | "retries" | "timeout" | "energy"

    @property
    def retries(self) -> int:
        """Retransmissions attempted (attempts beyond the first)."""
        return max(0, len(self.windows) - 1)


class FaultState:
    """Mutable per-run fault runtime (one per ``simulate`` call).

    Availability/fading caches are keyed by cloud round so every engine
    reads the identical schedule; energy balances and dispatch counters are
    the only order-dependent state (the sync paths debit in the same
    global-client order as the reference simulator, keeping their balances
    — and therefore their participation masks — in lockstep).
    """

    def __init__(
        self,
        spec: FaultSpec,
        topo: Topology,
        wp: WirelessParams,
        model_bits: float,
        class_counts: Optional[np.ndarray] = None,
        device="cuda",
    ):
        self.spec = spec
        self.device = device
        self.topo = topo
        self.wp = wp
        self.model_bits = float(model_bits)
        self.class_counts = None if class_counts is None else np.asarray(class_counts)
        if spec.reassign and self.class_counts is None:
            raise ValueError(
                "FaultSpec.reassign needs the scenario's class_counts to "
                "re-repair the assignment (pass class_counts=)"
            )
        self.m, self.n = np.asarray(topo.dist).shape
        self._avail: Dict[int, np.ndarray] = {}
        self._fade_block: Dict[int, np.ndarray] = {}
        self._drift: Dict[int, np.ndarray] = {}
        self._cost: Dict[int, CostMatrices] = {}
        self._disp: Dict[Tuple[int, int, int], int] = {}
        if spec.energy_uploads is None:
            self.energy_remaining = np.full(self.m, np.inf)
            self.energy_budget = np.full(self.m, np.inf)
        else:
            c1 = self.cost(1)
            mean_en = float(np.asarray(c1.energy)[np.asarray(c1.feasible)].mean())
            jitter = self._rng(_ENERGY).uniform(-1.0, 1.0, self.m)
            self.energy_budget = (
                spec.energy_uploads * mean_en * (1.0 + spec.energy_spread * jitter)
            )
            self.energy_remaining = self.energy_budget.copy()

    # -- keyed randomness ----------------------------------------------------
    def _rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng((self.spec.seed, *key))

    # -- availability churn --------------------------------------------------
    def availability(self, b: int) -> np.ndarray:
        """(M,) churn trace at cloud round ``b`` (1-indexed); pure in the
        spec, so it is THE cross-engine dropout schedule."""
        if 0 not in self._avail:
            self._avail[0] = self._rng(_AVAIL, 0).random(self.m) < self.spec.start_up
        last = max(self._avail)
        for t in range(last + 1, b + 1):
            u = self._rng(_AVAIL, t).random(self.m)
            up = self._avail[t - 1]
            self._avail[t] = np.where(up, u >= self.spec.p_drop, u < self.spec.p_rejoin)
        return self._avail[b].copy()

    def alive(self) -> np.ndarray:
        """(M,) EUs whose energy budget has not hit zero."""
        return self.energy_remaining > 0.0

    def participation(self, b: int) -> np.ndarray:
        """(M,) mask of EUs able to start round ``b``: churned-in AND alive."""
        return self.availability(b) & self.alive()

    # -- time-varying channel ------------------------------------------------
    def fading(self, b: int) -> np.ndarray:
        """(M, N) |h|^2 at round ``b``: Rayleigh block re-fade x slow drift."""
        sp = self.spec
        if sp.refade_rounds == 0:
            base = np.asarray(self.topo.fading_mag2)
        else:
            block = (b - 1) // sp.refade_rounds
            if block not in self._fade_block:
                u = self._rng(_FADE, block).uniform(1e-6, 1.0, (self.m, self.n))
                ray = np.sqrt(-2.0 * np.log(u)) / np.sqrt(2.0)
                self._fade_block[block] = np.square(ray)
            base = self._fade_block[block]
        if sp.drift_rate == 0.0:
            return base
        if 0 not in self._drift:
            self._drift[0] = np.ones((self.m, self.n))
        last = max(self._drift)
        for t in range(last + 1, b + 1):
            step = self._rng(_DRIFT, t).standard_normal((self.m, self.n))
            self._drift[t] = self._drift[t - 1] * np.exp(sp.drift_rate * step)
        return base * self._drift[b]

    def cost(self, b: int) -> CostMatrices:
        """The scenario's cost matrices re-evaluated at round ``b``'s fade."""
        if b not in self._cost:
            topo_b = dataclasses.replace(self.topo, fading_mag2=self.fading(b))
            self._cost[b] = build_cost_matrices(topo_b, self.model_bits, self.wp, device=self.device)
        return self._cost[b]

    def latency(self, b: int) -> np.ndarray:
        return self.cost(b).latency

    def energy(self, b: int) -> np.ndarray:
        return self.cost(b).energy

    def feasible(self, b: int) -> np.ndarray:
        return self.cost(b).feasible

    # -- energy accounting ----------------------------------------------------
    def debit(self, i: int, joules: float) -> None:
        """Clamp at zero: "an EU whose budget hits zero stops participating"."""
        if np.isfinite(self.energy_remaining[i]):
            self.energy_remaining[i] = max(0.0, self.energy_remaining[i] - joules)

    def upload_energy(self, b: int, i: int, edges: np.ndarray) -> float:
        """Energy of one multicast upload: the transmission must reach the
        costliest member edge."""
        en = np.asarray(self.energy(b))
        return float(en[i, np.asarray(edges, int)].max())

    def debit_round(self, b: int, attempted: np.ndarray, assignment: np.ndarray) -> None:
        """Synchronous-round debit: every attempted EU pays one multicast
        upload at round ``b``'s channel (in global client order, so the
        reference and sync engines keep identical balances)."""
        asn = np.asarray(assignment)
        for i in np.nonzero(np.asarray(attempted, bool))[0]:
            edges = np.nonzero(asn[i])[0]
            if len(edges):
                self.debit(int(i), self.upload_energy(b, int(i), edges))

    # -- mid-round upload losses ----------------------------------------------
    def failed_uploads(self, b: int, er: int) -> np.ndarray:
        """(M,) synchronous-round loss mask for edge round ``er`` of cloud
        round ``b``: the EU trained, but its (single, no-retry) upload died."""
        if self.spec.p_fail == 0.0:
            return np.zeros(self.m, bool)
        return self._rng(_FAIL, b, er).random(self.m) < self.spec.p_fail

    def plan_upload(self, b: int, i: int, j: int, latency_s: float) -> UploadPlan:
        """Resolve one async (EU, edge) upload cascade at dispatch time.

        Attempt 0's airtime energy is charged by the caller (it is the
        multicast transmission shared across the EU's member edges); each
        RETRY here debits the unicast eq. 16 energy for this edge.  A
        per-(round, EU, edge) dispatch counter keys the failure draws, so
        redispatches within a round get fresh randomness yet the whole
        schedule stays reproducible.
        """
        sp = self.spec
        disp = self._disp.get((b, i, j), 0)
        self._disp[(b, i, j)] = disp + 1
        en = float(np.asarray(self.energy(b))[i, j])
        t = 0.0
        windows: List[Tuple[float, float, int]] = []
        for a in range(sp.max_retries + 1):
            if a > 0:
                if self.energy_remaining[i] <= 0.0:
                    return UploadPlan(False, t, windows, "energy")
                self.debit(i, en)
            end = t + latency_s
            if sp.timeout_s is not None and end > sp.timeout_s:
                return UploadPlan(False, sp.timeout_s, windows, "timeout")
            windows.append((t, end, a))
            if not (self._rng(_FAIL, b, i, j, disp, a).random() < sp.p_fail):
                return UploadPlan(True, end, windows)
            t = end + sp.backoff_s * (2.0**a)
        return UploadPlan(False, t, windows, "retries")

    # -- assignment re-repair --------------------------------------------------
    def repair(self, b: int, assignment: np.ndarray):
        """Re-repair ``assignment`` against round ``b``'s feasible sets.

        Returns ``(new_lam, changed_rows)``; ``changed_rows`` is empty when
        drift did not invalidate any membership.
        """
        from repro_torch.core.assignment import repair_assignment

        if self.class_counts is None:
            raise ValueError("repair needs class_counts (see FaultState.__init__)")
        return repair_assignment(assignment, self.class_counts, self.feasible(b))

    # -- telemetry -------------------------------------------------------------
    def record_gauges(self, tel) -> None:
        """Energy-remaining / live-population gauges (any engine, any round)."""
        if not tel.enabled:
            return
        tel.metrics.set_gauge("faults_live", int(self.alive().sum()))
        finite = np.isfinite(self.energy_remaining)
        if finite.any():
            tel.metrics.set_gauge(
                "faults_energy_remaining_j", float(self.energy_remaining[finite].sum())
            )
