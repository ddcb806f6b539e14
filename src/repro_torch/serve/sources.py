"""Task sources: where an online scheduling session's work streams from.

A :class:`TaskSource` is the streaming half of the session API —
trace replay is just one source (:class:`WorkloadSource`), a generator or
list is another (:class:`IterableSource`), and a JSONL feed off a file,
stdin, or a socket's ``makefile()`` is a third (:class:`JsonlSource`).
Sources yield :class:`TaskSubmit` records; the session converts them to
runtime :class:`~repro_torch.runtime.Task` objects at admission time.

Contract: ``pull(until)`` returns every not-yet-emitted submission with
``t <= until`` in admission order, and submissions must be time-
nondecreasing (a feed is a log of arrivals; the engine's clock only moves
forward). ``prepare(runtime)`` runs once when the source is fed to a
session and installs whole-stream state the offline path would have set
up front — feasibility masks, the DAG critical-path bound, exogenous
eviction rows — which is what keeps incremental streaming byte-identical
to offline replay.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field

import numpy as np

from ..runtime.runtime import Task

__all__ = ["TaskSubmit", "TaskSource", "IterableSource", "WorkloadSource",
           "JsonlSource"]


@dataclass(frozen=True)
class TaskSubmit:
    """One admission request: the wire format of the session API.

    ``feasible`` is either ``None`` (unconstrained), a boolean mask over
    nodes, or a sequence of allowed node indices (the JSONL spelling).
    ``evictions`` lists exogenous requeue times addressed to this task.
    """

    t: float
    work: float
    packets: float = 1.0
    priority: int = 0
    tid: int | None = None
    evictions: tuple = ()
    ends_evicted: bool = False
    feasible: object = None
    parents: tuple = ()
    has_children: bool = False
    out_size: float = 0.0
    info: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "TaskSubmit":
        d = dict(d)
        t = d.pop("t", None)
        if t is None:
            t = d.pop("t_arrive")
        known = {k: d.pop(k) for k in ("work", "packets", "priority", "tid",
                                       "ends_evicted", "feasible",
                                       "has_children", "out_size")
                 if k in d}
        evictions = tuple(float(x) for x in d.pop("evictions", ()))
        parents = tuple(int(p) for p in d.pop("parents", ()))
        return cls(t=float(t), evictions=evictions, parents=parents,
                   info=d, **known)

    def to_task(self, tid: int, capacity: int | None = None) -> Task:
        """Lower to a runtime task. ``capacity`` (grid slot count) is
        needed only when ``feasible`` names node indices."""
        feasible = self.feasible
        if feasible is not None:
            feasible = np.asarray(feasible)
            if feasible.dtype != np.bool_:
                if capacity is None:
                    raise ValueError(
                        "feasible node indices need the cluster capacity "
                        "to become a mask; submit through a session")
                mask = np.zeros(capacity, dtype=bool)
                mask[feasible.astype(np.int64)] = True
                feasible = mask
        return Task(tid=tid, t_arrive=float(self.t), work=float(self.work),
                    packets=float(self.packets), priority=int(self.priority),
                    ends_evicted=bool(self.ends_evicted), feasible=feasible,
                    parents=tuple(self.parents),
                    has_children=bool(self.has_children),
                    out_size=float(self.out_size))


class TaskSource:
    """Base streaming source. Subclasses implement :meth:`pull`."""

    #: one past the highest task id this source will ever emit, when the
    #: stream's ids are known up front (None: ids unknown / allocated by
    #: the session). The session reserves the range so live auto-id
    #: submissions cannot collide with tasks not yet streamed in.
    tid_ceiling: int | None = None

    def prepare(self, runtime) -> None:
        """Install whole-stream state on the runtime (masks, eviction
        rows, DAG bounds). Called once when fed to a session."""

    def pull(self, until: float) -> list[TaskSubmit]:
        """Every not-yet-emitted submission with ``t <= until``, in
        admission order."""
        raise NotImplementedError

    @property
    def exhausted(self) -> bool:
        raise NotImplementedError


class IterableSource(TaskSource):
    """Wrap any iterable/generator of :class:`TaskSubmit` (or dicts).
    Items must be time-nondecreasing; one item of lookahead is buffered
    so ``pull(until)`` can stop exactly at the boundary."""

    def __init__(self, items):
        self._it = iter(items)
        self._buf: TaskSubmit | None = None
        self._done = False

    def _next(self) -> TaskSubmit | None:
        if self._buf is not None:
            ts, self._buf = self._buf, None
            return ts
        try:
            item = next(self._it)
        except StopIteration:
            self._done = True
            return None
        return item if isinstance(item, TaskSubmit) \
            else TaskSubmit.from_dict(item)

    def pull(self, until: float) -> list[TaskSubmit]:
        out = []
        while True:
            ts = self._next()
            if ts is None:
                break
            if ts.t > until:
                self._buf = ts
                break
            out.append(ts)
        return out

    @property
    def exhausted(self) -> bool:
        return self._done and self._buf is None


class JsonlSource(IterableSource):
    """JSONL feed: one task per line, e.g.
    ``{"t": 0.5, "work": 2.0, "packets": 3}``.

    Accepts a path, ``"-"`` for stdin, or any file-like / line iterable —
    a socket feed is ``sock.makefile("r")``. Blank lines are skipped.
    """

    def __init__(self, feed):
        self._close = None
        if feed == "-":
            lines = sys.stdin
        elif isinstance(feed, (str, bytes)):
            lines = open(feed)
            self._close = lines
        else:
            lines = feed
        super().__init__(self._parse(lines))

    def _parse(self, lines):
        try:
            for line in lines:
                line = line.strip()
                if line:
                    yield TaskSubmit.from_dict(json.loads(line))
        finally:
            if self._close is not None:
                self._close.close()


class WorkloadSource(TaskSource):
    """Stream a materialized :class:`~repro_torch.runtime.Workload`
    (including :class:`~repro_torch.traces.TraceSchema` replays) — offline
    replay recast as just another source.

    Emission order matches ``schedule_workload``'s admission order:
    time-sorted with same-instant ties broken best tier first. ``prepare``
    mirrors the offline path's up-front work — feasibility masks resolved
    once against the cluster attribute table, the DAG critical-path lower
    bound, and the whole eviction stream installed in row order (events
    addressed to tasks not yet streamed in are the same pre-arrival no-ops
    an offline replay fires) — so the streamed run is event-for-event
    identical to ``ClusterRuntime.run`` on the same workload.
    """

    def __init__(self, workload, tid_base: int = 0):
        self.workload = workload
        self.tid_base = tid_base
        self.tid_ceiling = tid_base + int(workload.m)
        self._prepared = False
        self._ptr = 0
        priority = getattr(workload, "priority", None)
        self._priority = np.asarray(
            priority if priority is not None else np.zeros(workload.m),
            dtype=np.int64)
        ends = getattr(workload, "ends_evicted", None)
        self._ends = np.asarray(
            ends if ends is not None else np.zeros(workload.m, dtype=bool),
            dtype=bool)
        # stable (t, tier) order: priority decides admission within a batch
        self._order = np.lexsort((self._priority, workload.t_arrive))
        self._masks = None
        self._parents_of = None
        self._has_child = None

    def prepare(self, runtime) -> None:
        wl = self.workload
        self._masks = runtime._resolve_feasibility(wl)
        dag = getattr(wl, "dag", None)
        if dag is not None and dag.empty:
            dag = None
        if dag is not None:
            self._parents_of = dag.parents_of()
            has_child = np.zeros(dag.m, dtype=bool)
            if dag.k:
                has_child[dag.parent] = True
            self._has_child = has_child
            self._out_size = dag.out_size
            runtime.metrics.cp_lower_bound = max(
                runtime.metrics.cp_lower_bound,
                dag.cp_lower_bound(wl.works, runtime._base_powers,
                                   wl.t_arrive))
        evictions = getattr(wl, "evictions", None)
        if evictions is not None and not evictions.empty:
            for j in range(evictions.k):
                runtime.schedule_eviction(
                    self.tid_base + int(evictions.task[j]),
                    float(evictions.time[j]))
        self._prepared = True

    def _submit(self, i: int) -> TaskSubmit:
        wl = self.workload
        parents = () if self._parents_of is None else tuple(
            self.tid_base + p for p in self._parents_of[i])
        return TaskSubmit(
            t=float(wl.t_arrive[i]), work=float(wl.works[i]),
            packets=float(wl.packets[i]), priority=int(self._priority[i]),
            tid=self.tid_base + i, ends_evicted=bool(self._ends[i]),
            feasible=None if self._masks is None else self._masks[i],
            parents=parents,
            has_children=bool(self._has_child[i])
            if self._has_child is not None else False,
            out_size=float(self._out_size[i])
            if self._parents_of is not None else 0.0)

    def pull(self, until: float) -> list[TaskSubmit]:
        if not self._prepared:
            wl = self.workload
            needs = any(
                x is not None and not getattr(x, "empty", True)
                for x in (getattr(wl, "constraints", None),
                          getattr(wl, "dag", None),
                          getattr(wl, "evictions", None)))
            if needs:
                raise RuntimeError(
                    "workload carries constraints/DAG/evictions; feed the "
                    "source to a session (which calls prepare()) first")
        t_arrive = self.workload.t_arrive
        out = []
        while self._ptr < self._order.size:
            i = int(self._order[self._ptr])
            if float(t_arrive[i]) > until:
                break
            out.append(self._submit(i))
            self._ptr += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._ptr >= self._order.size

    @property
    def next_time(self) -> float | None:
        """Arrival time of the next unstreamed task (micro-step pacing)."""
        if self.exhausted:
            return None
        return float(self.workload.t_arrive[int(self._order[self._ptr])])
