"""Task-lifecycle tracer with Chrome-trace / Perfetto JSON export.

Recording is the hot path — it runs inside the event engine's per-task
loop — so events are stored as compact tuples and only materialized into
Chrome trace-event form (``ph`` phases ``X`` complete / ``i`` instant /
``C`` counter) at export. Simulated time maps to the trace ``ts`` axis at
one time unit = 1 second (ts is microseconds per the spec); wall-clock
decision latencies go to a side accumulator (``decision_stats``) so they
never distort the simulated timeline.

Storage is a flat sequence of fixed-stride records (8 slots per event:
``ph, name, t0, dur, pid, tid, cat, args``) rather than one tuple per
event: the interpreter frees the argument tuple as soon as ``extend``
returns, so nothing the garbage collector tracks survives per event
(floats and interned strings are GC-exempt; the occasional ``args``
dict is the only tracked survivor). A list-of-tuples layout leaves one
tracked tuple alive per event, which drives thousands of extra gen-0
collections over a large run.

Ring mode (``ring=N``) swaps the list for a ``deque(maxlen=8 * N)`` —
same stride-8 records, and each ``extend`` of a full record evicts
exactly the oldest event; ``n_dropped`` counts what fell off. Open spans
(``begin``/``end``) are tracked outside the ring so a span whose begin
predates the ring window still closes correctly.

Causal ids: :meth:`next_span_id` allocates ids unique across a
federation (the member index rides in the high bits via ``instance``),
and callers attach ``trace_id`` / ``span_id`` / ``parent_id`` through
the ordinary ``args`` dict — only spans that participate in a causal
chain (WAN hand-offs and the lifecycle spans of handed-off tasks) pay
for ids, so the hot path stays id-free.

Decision latencies are sampled (the engine times placements 1-in-
``latency_sample``; see ``ObsSpec.latency_sample``) but counted in
full: each recorded sample carries the ``weight`` of the unsampled
decisions it represents, so ``decision_stats()`` reports the true
decision count ``n`` and percentiles ranked against it — under the
deterministic stride the reservoir's order statistics estimate the
population's, while a naive p99 of the sampled stream would claim a
census it never took.
"""

from __future__ import annotations

import json
import math
from collections import deque

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "PID_NODES", "PID_TASKS",
           "PID_SCHED"]

# Process lanes in the exported trace. Tasks get tid = task id under
# PID_TASKS, node events tid = node index under PID_NODES, scheduler
# decisions land on PID_SCHED.
PID_NODES = 1
PID_TASKS = 2
PID_SCHED = 3

_PROCESS_NAMES = {PID_NODES: "nodes", PID_TASKS: "tasks", PID_SCHED: "scheduler"}

# sim time unit -> trace microseconds (1 unit = 1 s)
_TS_SCALE = 1e6


class Tracer:
    """Records lifecycle spans, instants, counters and decision latencies."""

    enabled = True

    def __init__(self, *, ring: int | None = None, instance: int = 0,
                 latency_sample: int = 8):
        if ring is not None and ring <= 0:
            raise ValueError("ring must be positive or None")
        if latency_sample < 1:
            raise ValueError("latency_sample must be >= 1")
        self.ring = ring
        self._events: deque | list
        self._events = deque(maxlen=8 * ring) if ring is not None else []
        self._total = 0
        self._open: dict[tuple, tuple[float, dict]] = {}
        self._latency: dict[str, list[float]] = {}
        self._lat_n: dict[str, int] = {}
        #: placement-latency sampling stride the engine reads at
        #: construction (1 = census); see ``ObsSpec.latency_sample``
        self.latency_sample = int(latency_sample)
        #: federation member tag folded into span ids (0 = standalone)
        self.instance = int(instance)
        self._next_sid = 0

    def next_span_id(self) -> int:
        """Allocate a span id unique across federation members: the
        tracer's ``instance`` in the high bits, a local counter below."""
        self._next_sid += 1
        return (self.instance << 32) | self._next_sid

    # -- raw event plumbing --------------------------------------------
    # flat stride-8 records: ph, name, t0, dur, pid, tid, cat, args|None

    @property
    def n_events(self) -> int:
        return len(self._events) // 8

    @property
    def n_dropped(self) -> int:
        return self._total - len(self._events) // 8

    # -- recording API --------------------------------------------------
    # ``args`` is a plain dict (or None), not **kwargs: packing keyword
    # arguments costs ~3x a dict literal per call, and these methods run
    # once or twice per simulated task. The dict is stored by reference —
    # callers pass fresh literals and must not mutate them afterwards.

    def instant(self, name: str, t: float, pid: int = PID_TASKS,
                tid: int = 0, cat: str = "event",
                args: dict | None = None) -> None:
        self._events.extend(("i", name, t, 0.0, pid, tid, cat, args))
        self._total += 1

    def span(self, name: str, t0: float, t1: float, pid: int = PID_TASKS,
             tid: int = 0, cat: str = "span",
             args: dict | None = None) -> None:
        """Record a complete (``ph: X``) span covering [t0, t1]."""
        self._events.extend(("X", name, t0, t1 - t0, pid, tid, cat, args))
        self._total += 1

    def begin(self, key: tuple, t0: float, args: dict | None = None) -> None:
        """Open a span under an arbitrary key; closed later by ``end``."""
        self._open[key] = (t0, args)

    def end(self, key: tuple, name: str, t1: float, pid: int = PID_TASKS,
            tid: int = 0, cat: str = "span",
            args: dict | None = None) -> bool:
        """Close an open span; returns False if no matching ``begin``.
        ``args`` merges over (and wins against) the ``begin`` args."""
        opened = self._open.pop(key, None)
        if opened is None:
            return False
        t0, args0 = opened
        if args0 is not None:
            args = args0 if args is None else {**args0, **args}
        self.span(name, t0, t1, pid=pid, tid=tid, cat=cat, args=args)
        return True

    def counter(self, name: str, t: float, values: dict, *,
                pid: int = PID_NODES, tid: int = 0) -> None:
        self._events.extend(("C", name, t, 0.0, pid, tid, "counter",
                             dict(values)))
        self._total += 1

    def decision(self, kind: str, latency_s: float,
                 weight: int = 1, **args) -> None:
        """Record one scheduler decision's wall-clock latency.

        ``weight`` is how many decisions this sample stands for (the
        engine's placement stride); the reservoir keeps the sample, the
        count keeps the full population. Stats-only by design: a
        per-decision trace event would double the hot-path cost for
        information ``decision_stats()`` already carries (extra ``args``
        are accepted and ignored for the same reason).
        """
        lats = self._latency.get(kind)
        if lats is None:
            lats = self._latency[kind] = []
            self._lat_n[kind] = 0
        lats.append(latency_s)
        self._lat_n[kind] += weight

    # -- summaries ------------------------------------------------------
    def decision_stats(self) -> dict:
        """Per-decision-kind latency stats in microseconds.

        ``n`` is the *full* decision count (sampled-out decisions
        included via their sample's weight); ``sampled`` is the reservoir
        size. Percentiles are nearest-rank over the reservoir — under the
        engine's deterministic stride every sample represents the same
        number of decisions, so reservoir rank ``q`` estimates population
        rank ``q``.
        """
        out = {}
        for kind, lats in self._latency.items():
            xs = sorted(lats)
            s = len(xs)

            def rank(q, s=s, xs=xs):
                return xs[min(s - 1, max(0, math.ceil(q * s) - 1))]
            out[kind] = {
                "n": self._lat_n[kind],
                "sampled": s,
                "mean_us": sum(xs) / s * 1e6,
                "p99_us": rank(0.99) * 1e6,
                "p999_us": rank(0.999) * 1e6,
                "max_us": xs[-1] * 1e6,
            }
        return out

    # -- export ---------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        events = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": pname}}
            for pid, pname in _PROCESS_NAMES.items()
        ]
        # one dict literal per branch (no post-insert), bound append: this
        # loop is the bulk of export time for large traces. zip over one
        # shared iterator re-chunks the flat stride-8 storage into events.
        app = events.append
        scale = _TS_SCALE
        it = iter(self._events)
        for ph, name, t0, dur, pid, tid, cat, args in zip(*(it,) * 8):
            if ph == "X":
                app({"name": name, "cat": cat, "ph": ph, "ts": t0 * scale,
                     "dur": (dur if dur > 0.0 else 0.0) * scale, "pid": pid,
                     "tid": tid, "args": {} if args is None else args})
            elif ph == "i":
                app({"name": name, "cat": cat, "ph": ph, "ts": t0 * scale,
                     "s": "t", "pid": pid, "tid": tid,
                     "args": {} if args is None else args})
            else:
                app({"name": name, "cat": cat, "ph": ph, "ts": t0 * scale,
                     "pid": pid, "tid": tid,
                     "args": {} if args is None else args})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "n_events": self._total,
                "n_dropped": self.n_dropped,
                "decision_stats": self.decision_stats(),
            },
        }

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh, allow_nan=False)


class NullTracer:
    """No-op stand-in; every recording method swallows its arguments.

    Hot paths should prefer ``if tracer is not None`` guards, but code that
    wants an unconditional handle can use :data:`NULL_TRACER`.
    """

    enabled = False
    ring = None
    n_events = 0
    n_dropped = 0
    instance = 0
    latency_sample = 8

    def next_span_id(self):
        return 0

    def instant(self, *a, **k):
        pass

    def span(self, *a, **k):
        pass

    def begin(self, *a, **k):
        pass

    def end(self, *a, **k):
        return False

    def counter(self, *a, **k):
        pass

    def decision(self, *a, **k):
        pass

    def decision_stats(self):
        return {}

    def to_chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms", "otherData": {}}


NULL_TRACER = NullTracer()
