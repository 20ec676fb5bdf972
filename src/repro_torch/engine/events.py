"""Deterministic event queue for the asynchronous HFL simulator.

A plain binary heap keyed on (time, seq): the monotonically increasing ``seq``
makes pops total-ordered even when two uploads land at the same instant, so
async runs are reproducible for a fixed seed regardless of dict/hash order.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Dict, Optional


@dataclasses.dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    payload: Dict[str, Any] = dataclasses.field(compare=False, default_factory=dict)


class EventQueue:
    """Min-heap of :class:`Event` with a simulation clock."""

    def __init__(self):
        self._heap: list[Event] = []
        self._seq = itertools.count()
        self.now: float = 0.0

    def push(self, time: float, kind: str, **payload) -> Event:
        if time < self.now:
            raise ValueError(f"cannot schedule event at t={time} < now={self.now}")
        ev = Event(time, next(self._seq), kind, payload)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        return ev

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def clear(self) -> None:
        """Drop all pending events (e.g. in-flight stragglers at a barrier)."""
        self._heap.clear()
