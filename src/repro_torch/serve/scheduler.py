"""Scheduler-as-a-service: the incremental online engine.

:class:`SchedulerService` wraps one
:class:`~repro_torch.runtime.ClusterRuntime` as a long-lived service: tasks
stream in from :class:`TaskSource` feeds (trace replay, generators, JSONL
over stdin/socket), the engine advances in bounded micro-steps, and every
scheduling decision — placement, migration, eviction, completion, trigger
verdict — is emitted online as a structured :class:`Decision` record
through the runtime's decision sink (the same hook family the tracer's
latency probes ride on).

The service speaks the unified driving verbs (``submit`` / ``withdraw`` /
``advance`` / ``drain``) plus the operator verbs ``fail`` / ``join`` /
``resize``. ``from_scenario`` builds it from a declarative lab
:class:`~repro_torch.lab.Scenario` with exactly the events backend's
lowering, which is what makes the ``online`` lab backend's
``Metrics.summary()`` byte-identical to offline replay.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..runtime.runtime import ClusterRuntime
from .session import Session
from .sources import TaskSource, WorkloadSource

__all__ = ["Decision", "DecisionLog", "SchedulerService"]

#: decision kinds a sink observes, in the order the engine can emit them
DECISION_KINDS = ("place", "migrate", "evict", "complete", "trigger")


@dataclass(frozen=True)
class Decision:
    """One scheduling decision, emitted online as it is made.

    ``kind`` is one of :data:`DECISION_KINDS`. ``node`` is the acted-on
    node (placement target, completion node, eviction's node); migrations
    carry ``src``/``dst``. Trigger verdicts have no task (``tid == -1``)
    and record the fire/skip verdict in ``info["fired"]``.
    """

    seq: int
    t: float
    kind: str
    tid: int = -1
    node: int = -1
    src: int = -1
    dst: int = -1
    info: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"seq": self.seq, "t": self.t, "kind": self.kind}
        if self.tid >= 0:
            d["tid"] = self.tid
        if self.node >= 0:
            d["node"] = self.node
        if self.kind == "migrate":
            d["src"], d["dst"] = self.src, self.dst
        if self.info:
            d.update(self.info)
        return d


class DecisionLog:
    """Decision sink: collects :class:`Decision` records in order and/or
    streams them to a callback as they happen.

    Implements the runtime's decision-sink protocol (``place`` /
    ``migrate`` / ``evict`` / ``complete`` / ``trigger``). With
    ``keep=False`` nothing is retained — pure streaming through
    ``on_decision`` — so an unbounded service does not grow memory.
    """

    def __init__(self, *, keep: bool = True, on_decision=None):
        self.decisions: list[Decision] = []
        self._keep = keep
        self._cb = on_decision
        self.seq = 0
        self.counts = dict.fromkeys(DECISION_KINDS, 0)

    def _emit(self, d: Decision) -> None:
        self.seq += 1
        self.counts[d.kind] += 1
        if self._keep:
            self.decisions.append(d)
        if self._cb is not None:
            self._cb(d)

    # -- sink protocol -------------------------------------------------------
    def place(self, t, task, node) -> None:
        self._emit(Decision(self.seq, t, "place", tid=task.tid, node=node))

    def migrate(self, t, task, src, dst) -> None:
        self._emit(Decision(self.seq, t, "migrate", tid=task.tid,
                            src=src, dst=dst))

    def evict(self, t, task, running) -> None:
        self._emit(Decision(self.seq, t, "evict", tid=task.tid,
                            node=task.node, info={"running": bool(running)}))

    def complete(self, t, task, node) -> None:
        self._emit(Decision(self.seq, t, "complete", tid=task.tid,
                            node=node))

    def trigger(self, t, fired) -> None:
        self._emit(Decision(self.seq, t, "trigger",
                            info={"fired": bool(fired)}))

    def alert(self, t, record) -> None:
        """Anomaly alerts ride the same stream as decisions (kind
        ``alert``, detector and detail in ``info``)."""
        self.counts.setdefault("alert", 0)
        self._emit(Decision(self.seq, t, "alert", info=dict(record)))

    # -- consumption ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.decisions)

    def __iter__(self):
        return iter(self.decisions)

    def drain(self) -> list[Decision]:
        """Pop and return everything collected since the last drain."""
        out, self.decisions = self.decisions, []
        return out


class SchedulerService:
    """An incremental scheduling engine behind the session API.

    Wraps a runtime (or builds one from a lab scenario) and exposes:

    * ``attach(source)`` — feed a :class:`TaskSource` (trace, generator,
      JSONL); ``submit``/``withdraw`` admit and remove single tasks live.
    * ``advance(until=..., max_events=...)`` — one bounded micro-step;
      returns the :class:`Decision` records made during the step.
    * ``fail``/``join``/``resize`` — operator verbs for machine events.
    * ``drain()`` — run dry; ``summary()`` — the canonical 25-key metrics.

    Any registered policy works unchanged — ``request_sched`` and
    ``straggler`` (the latency-instrumented policies) are the first
    online policies by construction, since the service drives the same
    policy surface replay does.
    """

    def __init__(self, runtime: ClusterRuntime, *, log: DecisionLog | None
                 = None):
        from ..obs import FanoutSink
        self.rt = runtime
        self.log = DecisionLog() if log is None else log
        # install the log *alongside* any sink already wired in (e.g. the
        # RegistryCollector an ObsSpec(metrics=True) lowering installed)
        existing = runtime._sink
        if existing is None:
            runtime._sink = self.log
        elif isinstance(existing, FanoutSink):
            existing.sinks.append(self.log)
        else:
            runtime._sink = FanoutSink([existing, self.log])
        self.session = Session(runtime)
        self.instruments = None

    @classmethod
    def from_scenario(cls, scenario, *, attach_workload: bool = True,
                      log: DecisionLog | None = None) -> "SchedulerService":
        """Build from a declarative lab scenario using exactly the events
        backend's lowering (same runtime construction, same fault
        schedule, same instruments), so an online run reproduces offline
        replay metrics byte-for-byte."""
        from ..lab.backends import build_events_runtime
        rt, wl, ins, (failures, joins, resizes) = \
            build_events_runtime(scenario)
        svc = cls(rt, log=log)
        svc.instruments = ins
        rt.schedule_faults(failures=failures, joins=joins, resizes=resizes)
        if attach_workload:
            svc.attach(WorkloadSource(wl))
        return svc

    # -- feeding -------------------------------------------------------------
    def attach(self, source: TaskSource) -> TaskSource:
        return self.session.feed(source)

    def submit(self, item, t: float | None = None, *, evictions=()):
        return self.session.submit(item, t, evictions=evictions)

    def withdraw(self, task) -> None:
        self.session.withdraw(task)

    # -- operator verbs ------------------------------------------------------
    def fail(self, node: int, t: float | None = None) -> None:
        self.rt.post_failure(node, t)

    def join(self, node: int, t: float | None = None) -> None:
        self.rt.post_join(node, t)

    def resize(self, node: int, fraction: float,
               t: float | None = None) -> None:
        self.rt.post_resize(node, fraction, t)

    # -- stepping ------------------------------------------------------------
    def advance(self, until: float | None = None, *,
                max_events: int | None = None) -> list[Decision]:
        """One bounded micro-step; returns the decisions it produced."""
        mark = len(self.log.decisions)
        self.session.advance(until, max_events=max_events)
        return self.log.decisions[mark:]

    def drain(self, *, max_events: int = 2_000_000):
        """Run everything attached to completion; returns metrics."""
        return self.session.drain(max_events=max_events)

    def close(self):
        return self.session.close()

    # -- inspection ----------------------------------------------------------
    @property
    def now(self) -> float:
        return self.rt._now

    @property
    def metrics(self):
        return self.rt.metrics

    def summary(self) -> dict:
        return self.rt.metrics.summary()

    def scrape(self) -> str:
        """OpenMetrics exposition of the live engine (see
        :meth:`Session.scrape`)."""
        return self.session.scrape()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
