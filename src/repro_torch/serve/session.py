"""Session lifecycle over one :class:`~repro_torch.runtime.ClusterRuntime`.

``rt.open_session()`` returns a :class:`Session` — the explicit spelling
of what the monolithic ``run()`` composes implicitly::

    s = ClusterRuntime(powers, "psts").open_session()
    s.feed(WorkloadSource(workload))     # trace replay is just a source
    s.advance(until=10.0)                # bounded micro-step
    s.submit(TaskSubmit(t=10.5, work=2)) # live admission between steps
    metrics = s.drain()                  # run the queue dry
    s.close()

The driving verbs — ``submit`` / ``withdraw`` / ``advance`` / ``drain`` —
are the same names :class:`~repro_torch.runtime.ClusterRuntime`,
:class:`~repro_torch.federation.FederatedRuntime`, and
:class:`~repro_torch.serve.SchedulerService` share.
"""

from __future__ import annotations

import math

from ..runtime.runtime import ClusterRuntime, Task
from .sources import TaskSource, TaskSubmit

__all__ = ["Session"]


class Session:
    """Feed / submit / advance / drain / close over one runtime.

    ``advance(until)`` first pulls every attached source up to ``until``
    (arrivals must be queued before the clock passes them — that is the
    whole online/offline equivalence argument), then moves the engine.
    Live ``submit`` between steps takes a :class:`TaskSubmit`, a dict, or
    a prebuilt :class:`~repro_torch.runtime.Task`; task ids are allocated
    from a session counter when not given.
    """

    def __init__(self, runtime: ClusterRuntime):
        self.rt = runtime
        self._sources: list[TaskSource] = []
        self._next_tid = 0
        self.closed = False

    # -- feeding -------------------------------------------------------------
    def feed(self, source: TaskSource) -> TaskSource:
        """Attach a task source; its whole-stream state (feasibility
        masks, eviction rows, DAG bounds) installs now."""
        self._check_open()
        source.prepare(self.rt)
        if source.tid_ceiling is not None:
            # ids this source will emit later must stay off-limits to
            # the live-submission allocator
            self._next_tid = max(self._next_tid, source.tid_ceiling)
        self._sources.append(source)
        return source

    def _alloc_tid(self) -> int:
        while self._next_tid in self.rt.tasks:
            self._next_tid += 1
        tid = self._next_tid
        self._next_tid += 1
        return tid

    def _coerce(self, item) -> Task:
        if isinstance(item, Task):
            self._next_tid = max(self._next_tid, item.tid + 1)
            return item
        if isinstance(item, dict):
            item = TaskSubmit.from_dict(item)
        tid = item.tid if item.tid is not None else self._alloc_tid()
        self._next_tid = max(self._next_tid, tid + 1)
        return item.to_task(tid, capacity=self.rt.grid.capacity)

    def submit(self, item, t: float | None = None, *,
               evictions=()) -> Task:
        """Admit one task live. ``t`` defaults to the submission's own
        arrival time (or now, for a prebuilt Task)."""
        self._check_open()
        if t is None and isinstance(item, (TaskSubmit, dict)):
            t = (item.t if isinstance(item, TaskSubmit)
                 else item.get("t", item.get("t_arrive")))
        if not evictions and isinstance(item, TaskSubmit):
            evictions = item.evictions
        task = self._coerce(item)
        self.rt.submit(task, t, evictions=evictions)
        return task

    def withdraw(self, task: Task) -> None:
        """Remove a queued task (the federation hand-off verb)."""
        self._check_open()
        self.rt.withdraw(task)

    # -- stepping ------------------------------------------------------------
    def _pull(self, until: float) -> int:
        n = 0
        for src in self._sources:
            for ts in src.pull(until):
                self.submit(ts)
                n += 1
        self._sources = [s for s in self._sources if not s.exhausted]
        return n

    def advance(self, until: float | None = None, *,
                max_events: int | None = None, strict: bool = False) -> int:
        """One bounded micro-step: pull sources up to ``until`` (all of
        them, when ``until`` is ``None``), then process queued events."""
        self._check_open()
        self._pull(math.inf if until is None else until)
        return self.rt.advance(until, max_events=max_events, strict=strict)

    def drain(self, *, max_events: int = 2_000_000):
        """Pull everything and run the event queue dry; returns metrics."""
        self._check_open()
        self._pull(math.inf)
        return self.rt.drain(max_events=max_events)

    @property
    def pending_sources(self) -> bool:
        return any(not s.exhausted for s in self._sources)

    def next_feed_time(self) -> float | None:
        """Earliest next arrival across attached sources, when knowable
        (``WorkloadSource`` exposes it; live feeds do not)."""
        times = [s.next_time for s in self._sources
                 if getattr(s, "next_time", None) is not None]
        return min(times) if times else None

    # -- observability -------------------------------------------------------
    def scrape(self) -> str:
        """Prometheus/OpenMetrics exposition of the runtime's current
        state. Get-or-creates a :class:`repro_torch.obs.RegistryCollector` on
        the runtime (reusing one installed by ``ObsSpec(metrics=True)``),
        refreshes its gauges from live engine state, and renders the
        text format. First call on an uninstrumented runtime starts the
        streaming counters from that moment."""
        from ..obs import attach_collector
        return attach_collector(self.rt).scrape()

    # -- lifecycle -----------------------------------------------------------
    @property
    def metrics(self):
        return self.rt.metrics

    def close(self):
        """End the session; returns the final metrics. Idempotent."""
        self.closed = True
        return self.rt.metrics

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError("session is closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
