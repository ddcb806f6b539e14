"""Discrete-event primitives for the cluster runtime.

A binary-heap clock with a total, deterministic order: events at equal
timestamps resolve by kind (failures first, so state changes are visible to
everything else at that instant; trigger evaluations last, so they see the
instant's arrivals/completions) and then by insertion sequence.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from enum import IntEnum
from typing import Any

__all__ = ["EventKind", "Event", "EventQueue"]


class EventKind(IntEnum):
    """Tie-break order at equal timestamps (lower = earlier).

    Completions resolve before evictions: a task whose service ends at
    exactly the eviction instant has, by then, done its work — evicting it
    would waste a finished run on a timestamp tie. Resizes follow the other
    capacity events (fail/join) so a same-instant fail-then-resize acts on
    the post-failure grid.
    """

    NODE_FAIL = 0
    NODE_JOIN = 1
    NODE_RESIZE = 2
    COMPLETION = 3
    EVICTION = 4
    MIGRATION_ARRIVE = 5
    ARRIVAL = 6
    TRIGGER_EVAL = 7
    # telemetry sampling resolves after everything else at an instant, so a
    # probe sees the state the instant leaves behind (including a trigger's
    # migrations); purely observational — never mutates cluster state
    PROBE_SAMPLE = 8


@dataclass(frozen=True)
class Event:
    time: float
    kind: EventKind
    payload: Any = None


class EventQueue:
    """Priority queue over ``Event`` with deterministic tie-breaking."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, int, Event]] = []
        self._seq = 0
        self._pending: dict[EventKind, int] = {k: 0 for k in EventKind}

    def push(self, time: float, kind: EventKind, payload: Any = None) -> None:
        ev = Event(float(time), kind, payload)
        heapq.heappush(self._heap, (ev.time, int(kind), self._seq, ev))
        self._seq += 1
        self._pending[kind] += 1

    def pop(self) -> Event:
        _, _, _, ev = heapq.heappop(self._heap)
        self._pending[ev.kind] -= 1
        return ev

    def peek_time(self) -> float:
        return self._heap[0][0]

    def pending(self, *kinds: EventKind) -> int:
        """Number of queued events of the given kinds (all kinds if empty)."""
        if not kinds:
            return len(self._heap)
        return sum(self._pending[k] for k in kinds)

    def extract(self, kind: EventKind, match) -> list[Event]:
        """Remove and return every queued event of ``kind`` whose payload
        satisfies ``match``, in time order. The heap is rebuilt once, so
        callers can re-target a whole batch (e.g. a migrated task's
        remaining eviction rows) at linear cost."""
        if not self._pending[kind]:
            return []
        keep, out = [], []
        for item in self._heap:
            ev = item[3]
            if ev.kind == kind and match(ev.payload):
                out.append(ev)
            else:
                keep.append(item)
        if out:
            heapq.heapify(keep)
            self._heap = keep
            self._pending[kind] -= len(out)
        return sorted(out, key=lambda ev: ev.time)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
