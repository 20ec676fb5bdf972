"""Round reporting: CommAccountant deltas, per-round JSONL, summary table.

The engines report one record per cloud round via ``Telemetry.on_round``;
this module supplies the pieces that turn those records into artifacts:

* :class:`CommDelta` — snapshots a :class:`~repro_torch.core.hfl.CommAccountant`
  and yields per-round traffic deltas (eu↔edge up/down bits, edge↔cloud
  bits, edge/cloud round counts), so round records carry *incremental*
  communication rather than cumulative totals.
* :func:`write_rounds_jsonl` — one JSON record per cloud round.
* :func:`summary_table` — fixed-width end-of-run table (also attached to
  ``SimResult`` via the telemetry object).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


class CommDelta:
    """Per-round deltas of a CommAccountant's cumulative totals."""

    def __init__(self, accountant) -> None:
        self._acc = accountant
        self._prev: Dict[str, float] = self._totals()

    def _totals(self) -> Dict[str, float]:
        if self._acc is None:
            return {}
        return self._acc.totals()

    def take(self) -> Dict[str, float]:
        """Totals accumulated since the previous ``take()`` (or init)."""
        cur = self._totals()
        out = {k: cur[k] - self._prev.get(k, 0.0) for k in cur}
        self._prev = cur
        return out


def write_rounds_jsonl(path, rounds: List[dict]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", encoding="utf-8") as f:
        for r in rounds:
            f.write(json.dumps(r) + "\n")
    return path


def _fmt(v, width: int) -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        if v != 0 and (abs(v) >= 1e5 or abs(v) < 1e-3):
            return f"{v:.2e}".rjust(width)
        return f"{v:.4f}".rstrip("0").rstrip(".").rjust(width)
    return str(v).rjust(width)


def summary_table(rounds: List[dict]) -> str:
    """Fixed-width table over the per-round records (for terminals/logs)."""
    if not rounds:
        return "(no rounds recorded)"
    cols = ["round", "acc", "loss", "wall_s", "sim_s",
            "eu_up_mb", "eu_down_mb", "cloud_mb"]
    widths = {c: max(len(c), 10) for c in cols}
    lines = ["  ".join(c.rjust(widths[c]) for c in cols)]
    lines.append("  ".join("-" * widths[c] for c in cols))
    for r in rounds:
        row = {
            "round": r.get("round"),
            "acc": r.get("acc"),
            "loss": r.get("loss"),
            "wall_s": r.get("wall_s"),
            "sim_s": r.get("sim_s"),
            "eu_up_mb": _mb(r.get("eu_up_bits")),
            "eu_down_mb": _mb(r.get("eu_down_bits")),
            "cloud_mb": _mb(r.get("cloud_bits")),
        }
        lines.append("  ".join(_fmt(row[c], widths[c]) for c in cols))
    return "\n".join(lines)


def _mb(bits) -> float | None:
    return None if bits is None else float(bits) / 8e6
