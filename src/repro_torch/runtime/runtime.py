"""Event-driven cluster runtime (the paper's dynamic setting, made explicit).

Drives the hypergrid/PSTS/trigger core through time: tasks arrive staggered,
each node is a FIFO server draining work at its processing power tau, nodes
fail and rejoin (the paper's virtual-node treatment, section 4.1), and a
periodic crossover-trigger evaluation decides online when a full PSTS
rebalance pays (section 5). Operation is nonpreemptive: a task that has
started service finishes where it is; only *queued* tasks migrate, and a
migration is in flight for ``packets / bandwidth`` time units during which
the task is on no node's queue.

Failure semantics: the failed node's queued tasks and its running task are
re-placed through the policy (the running task restarts from scratch —
nonpreemptive schedulers cannot checkpoint mid-task). Migrations in flight
toward a node that died on arrival are re-placed the moment they land.

Churn replay: trace workloads may carry exogenous *eviction* events
((task, time) rows — Google EVICT/KILL/FAIL) and the fault schedule may
carry *resizes* ((time, node, fraction) — machine_events capacity UPDATEs).
An eviction pulls the task off its machine, discards the interrupted
attempt's progress (``Metrics.wasted_work``) and requeues the task through
the normal tier-ordered admission path; a resize banks the running task's
progress (``Task.work_done``) and continues it at the new rate. Work-unit
conservation is auditable at any instant via :meth:`ClusterRuntime.\
work_census`: admitted == completed + in-flight, with wasted service
accounted on top.

Every policy (``repro_torch.runtime.policies``) runs under the identical
engine and reports through the shared ``Metrics`` accumulator.

Session lifecycle: the monolithic ``run()`` is a convenience over
four explicit primitives — ``schedule_workload`` / ``submit`` feed work in,
``advance(until=..., max_events=...)`` moves the clock in bounded
micro-steps, ``drain()`` runs the queue dry. The canonical driving verbs are
``submit`` / ``withdraw`` / ``advance`` / ``drain``; ``inject`` and
``step_until`` remain as deprecated spellings. ``open_session()`` (the
session handle over these verbs) comes with the serve slice of the port.

The engine is host code (numpy and the standard library), line for line the
JAX package's ``repro.runtime.runtime``: both run the same operations in the
same order, so one scenario gives the same ``Metrics.summary()`` in both.
"""

from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field

import numpy as np

from ..core.hypergrid import HyperGrid, embed, optimal_dim
from ..core.psts import psts_schedule
from ..obs.tracer import PID_NODES, PID_SCHED
from .events import EventKind, EventQueue
from .metrics import Metrics
from .policies import Policy, make_policy
from .workload import Workload

__all__ = ["Task", "ClusterView", "ClusterRuntime", "InfeasibleTaskError",
           "run_policy"]


class InfeasibleTaskError(ValueError):
    """A task's constraints exclude every node in the cluster — surfaced
    as a diagnostic naming the task and its predicates, never a hang."""


@dataclass
class Task:
    tid: int
    t_arrive: float
    work: float
    packets: float
    node: int = -1
    t_start: float | None = None
    t_finish: float | None = None
    restarts: int = 0
    migrations: int = 0
    evictions: int = 0
    # remaining-work bookkeeping: progress banked within the *current*
    # service attempt (a node resize banks it and continues at the new
    # rate); an eviction or failure restart discards it — nonpreemptive
    # schedulers cannot checkpoint mid-task
    work_done: float = 0.0
    # when the current attempt entered service; survives resizes (which
    # rebase t_start to rebase progress), so the wait metric — time from
    # arrival to the final attempt's start — stays exact under churn
    t_attempt_start: float | None = None
    # invalidates in-queue COMPLETION events after a restart or resize
    token: int = 0
    # the trace says this task's real-cluster life ended in an eviction
    # (end-mode replay: its completion is counted as an eviction too)
    ends_evicted: bool = False
    # priority tier (0 = most important): orders admission within an
    # arrival batch and service within a node's queue, nonpreemptively
    priority: int = 0
    # constraint feasibility over grid slots (None = feasible everywhere);
    # set once at admission from the trace's constraints x cluster attrs
    feasible: np.ndarray | None = None
    # DAG wiring: parent task ids this task must wait for, the count
    # still unfinished (authoritative once the task has arrived), whether
    # any task depends on this one (pins it against WAN hand-offs), the
    # bytes this task materializes on its node, and where it materialized
    # them (-1 until completion)
    parents: tuple[int, ...] = ()
    parents_left: int = 0
    has_children: bool = False
    out_size: float = 0.0
    output_node: int = -1
    # (time, node) history of every placement decision, for invariant checks
    placements: list[tuple[float, int]] = field(default_factory=list)
    # causal trace context: ``(trace_id, parent_span_id)`` set when
    # the task crosses a WAN link, so the destination cluster's tracer
    # stitches its spans to the source's. None for tasks that never
    # handed off — the hot path stays id-free.
    trace_ctx: tuple | None = None

    @property
    def state(self) -> str:
        if self.t_finish is not None:
            return "done"
        if self.t_start is not None:
            return "running"
        if self.node >= 0:
            return "queued"
        return "blocked" if self.parents_left > 0 else "in_flight"


@dataclass(frozen=True)
class ClusterView:
    """What a policy is allowed to see at decision time."""

    time: float
    grid: HyperGrid
    loads: np.ndarray          # queued + remaining running work per node
    m_seen: int                # arrivals so far
    rng: np.random.Generator   # engine-owned, for stochastic policies
    # feasible nodes for the task under decision (None = all); constraint-
    # blind runs never populate this, so policies stay mask-oblivious there
    feasible: np.ndarray | None = None
    # per-node transfer time the task under decision would pay fetching its
    # parents' outputs (None = no DAG inputs); locality-aware policies fold
    # it into their score, others ignore it — the engine charges it either
    # way, so ignoring it is a policy choice, not an accounting leak
    xfer: np.ndarray | None = None


class ClusterRuntime:
    """One cluster, one policy, one metrics accumulator."""

    def __init__(self, powers, policy: str | Policy = "psts", *,
                 d: int | None = None, trigger_period: float = 2.0,
                 bandwidth: float = 64.0,
                 link_bandwidth: float | None = None, seed: int = 0,
                 policy_kwargs: dict | None = None,
                 node_attrs: dict | None = None,
                 constraint_blind: bool = False,
                 tracer=None, probe=None, trigger_monitor=None,
                 decision_sink=None, anomaly=None):
        powers = np.asarray(powers, dtype=np.float64)
        self._base_powers = powers.copy()   # nominal, never mutated
        self._powers_full = powers.copy()   # current (resize-adjusted)
        self.grid = embed(powers, optimal_dim(powers.size) if d is None else d)
        self.policy = make_policy(policy, **(policy_kwargs or {}))
        self.trigger_period = float(trigger_period)
        self.bandwidth = float(bandwidth)
        # intra-cluster data-fabric rate for DAG parent-output fetches;
        # defaults to the migration bandwidth when not set apart
        self.link_bandwidth = (float(link_bandwidth)
                               if link_bandwidth is not None
                               else float(bandwidth))
        self.rng = np.random.default_rng(seed)
        self.metrics = Metrics()
        self.tasks: dict[int, Task] = {}
        self._queues: list[list[Task]] = [[] for _ in range(self.grid.capacity)]
        self._running: list[Task | None] = [None] * self.grid.capacity
        self._in_flight: set[int] = set()
        # release frontier: arrived tasks whose parents have not all
        # completed live here, outside every queue — rebalancing, stranding
        # and federation withdrawal only ever see *released* tasks, so the
        # positional rule stays defined on the released frontier alone.
        # _pending_parents counts unfinished parents for tasks that have
        # not arrived yet (popped onto Task.parents_left at arrival);
        # _children maps a parent tid to the tids it gates.
        self._blocked: dict[int, Task] = {}
        self._pending_parents: dict[int, int] = {}
        self._children: dict[int, list[int]] = {}
        self._eq = EventQueue()
        self._now = 0.0
        # node attribute table for placement constraints: {name: (n,) values}
        # over *physical* nodes (virtual padding slots are never feasible)
        self.attr_names: tuple[str, ...] = ()
        self.attr_matrix: np.ndarray | None = None
        if node_attrs:
            names = tuple(sorted(node_attrs))
            cols = []
            for name in names:
                col = np.asarray(node_attrs[name], dtype=np.float64)
                if col.shape != (powers.size,):
                    raise ValueError(
                        f"node attr {name!r}: {col.shape[0] if col.ndim else 0}"
                        f" values for {powers.size} nodes")
                cols.append(col)
            self.attr_names = names
            self.attr_matrix = np.stack(cols, axis=1)
        # blind mode: the engine still *enforces* feasibility (a constrained
        # task never lands on an infeasible node) but hides the mask from
        # the policy — the constraint-unaware baseline trace benchmarks use
        self.constraint_blind = bool(constraint_blind)
        # telemetry (repro_torch.obs): every hook below guards on
        # `is not None`, so a bare runtime pays nothing — the tests assert
        # enabling these changes no Metrics.summary() value
        self._tr = tracer
        self._probe = probe
        self._mon = trigger_monitor
        # online decision feed (e.g. repro_torch.obs.RegistryCollector): an
        # object with place/migrate/evict/trigger/complete methods, called
        # as decisions happen. Like the tracer it guards on `is not None`
        # and reads engine state only — enabling it changes no
        # Metrics.summary() value. Sink calls are
        # exception-guarded (_sink_emit): a flaky consumer must not corrupt
        # engine state mid-event, so failures are counted, not raised.
        self._sink = decision_sink
        self.sink_errors = 0
        if decision_sink is not None and hasattr(decision_sink, "bind"):
            decision_sink.bind(self)
        # online anomaly detection (repro_torch.obs.anomaly): rides the probe
        # chain; alerts flow out through the decision sink's `alert` hook
        self._anom = anomaly
        if anomaly is not None and probe is None:
            raise ValueError("anomaly detection rides the probe chain; "
                             "pass probe= as well")
        # probe fast path: queued work per node / per tier maintained
        # incrementally at every queue mutation, so a probe sample is
        # O(nodes) instead of O(queued tasks). Only kept while probes are
        # enabled (the accumulators feed nothing else); incremental
        # subtraction leaves float residue ~1e-13, clamped at sample time
        self._track = probe is not None
        self._queued_work = [0.0] * self.grid.capacity
        self._queued_tier: dict[int, float] = {}
        # placement-latency sampling clock; the stride comes from the
        # tracer (ObsSpec.latency_sample, default 1-in-8)
        self._dec_count = 0
        self._lat_every = (int(getattr(tracer, "latency_sample", 8) or 8)
                           if tracer is not None else 8)

    # -- decision-sink guard ------------------------------------------------
    def _sink_emit(self, method: str, *args) -> None:
        """Deliver one decision-sink callback, absorbing consumer faults:
        a sink that raises must not corrupt engine state mid-event, so the
        failure is counted (``sink_errors``, surfaced in the metrics
        registry) and the event handler keeps advancing. Methods the sink
        does not implement (e.g. ``alert`` on an older sink) are skipped."""
        fn = getattr(self._sink, method, None)
        if fn is None:
            return
        try:
            fn(*args)
        except Exception:
            self.sink_errors += 1

    # -- state inspection ---------------------------------------------------
    def _progress(self, task: Task, node: int, t: float) -> float:
        """Service delivered to a *running* task so far: progress banked
        across resizes plus the current segment at the node's rate."""
        done = task.work_done + (t - task.t_start) * self.grid.powers[node]
        return float(min(max(done, 0.0), task.work))

    def loads(self, t: float) -> np.ndarray:
        """Queued work plus the remaining work of running tasks."""
        loads = np.zeros(self.grid.capacity)
        for n, q in enumerate(self._queues):
            for task in q:
                loads[n] += task.work
            r = self._running[n]
            if r is not None:
                loads[n] += r.work - self._progress(r, n, t)
        return loads

    def total_load(self, t: float) -> float:
        """Cluster-level outstanding work W_c at ``t`` — the one number a
        federation balancer sees for this member."""
        return float(self.loads(t).sum())

    @property
    def total_power(self) -> float:
        """Cluster-level power Pi_c under the current grid state."""
        return float(self.grid.total_power)

    def view(self, t: float,
             feasible: np.ndarray | None = None) -> ClusterView:
        return ClusterView(time=t, grid=self.grid, loads=self.loads(t),
                           m_seen=self.metrics.arrived, rng=self.rng,
                           feasible=feasible)

    def _outstanding(self) -> int:
        queued = sum(len(q) for q in self._queues)
        running = sum(r is not None for r in self._running)
        return queued + running + len(self._in_flight) + len(self._blocked)

    def census(self) -> dict:
        """Where every live task is right now — the quantity conservation
        checks (federation, tests) audit against arrivals/completions."""
        return {
            "queued": sum(len(q) for q in self._queues),
            "running": sum(r is not None for r in self._running),
            "in_flight": len(self._in_flight),
            "blocked": len(self._blocked),
            "pending_arrivals": self._eq.pending(EventKind.ARRIVAL),
            "pending_migrations": self._eq.pending(
                EventKind.MIGRATION_ARRIVE),
        }

    def work_census(self, t: float | None = None) -> dict:
        """Work-unit conservation snapshot at time ``t`` (default: now).

        ``admitted`` (every admitted task's demand, counted once) always
        equals ``completed + in_flight`` — work never leaks, however much
        eviction/failure churn replays. ``wasted`` rides on top: service
        burned on interrupted attempts, i.e. total service demand
        (admitted + wasted, evicted attempts redone) partitions into
        completed + wasted + in_flight. The eviction benchmarks and the
        conformance suite assert both identities.
        """
        t = self._now if t is None else float(t)
        queued = sum(task.work for q in self._queues for task in q)
        running_left = running_progress = 0.0
        for n, r in enumerate(self._running):
            if r is not None:
                p = self._progress(r, n, t)
                running_progress += p
                running_left += r.work - p
        migrating = sum(self.tasks[tid].work for tid in self._in_flight
                        if tid in self.tasks)
        blocked = sum(task.work for task in self._blocked.values())
        in_flight = (queued + running_left + running_progress + migrating
                     + blocked)
        m = self.metrics
        return {
            "admitted": m.admitted_work,
            "completed": m.completed_work,
            "wasted": m.wasted_work,
            "queued": queued,
            "running_left": running_left,
            "running_progress": running_progress,
            "migrating": migrating,
            "blocked": blocked,
            "in_flight": in_flight,
            "conservation_gap": abs(
                m.admitted_work - m.completed_work - in_flight),
        }

    def pending_work(self) -> bool:
        """True while any task is live here or scheduled to become live
        (arrivals, migrations or completions still in the event queue)."""
        return bool(self._outstanding() or self._eq.pending(
            EventKind.ARRIVAL, EventKind.MIGRATION_ARRIVE,
            EventKind.COMPLETION))

    # -- mechanics ----------------------------------------------------------
    def _admit(self, task: Task, t: float) -> None:
        """Admission gate of the release frontier: a task with unfinished
        parents holds in ``_blocked`` (on no queue — invisible to
        rebalancing, stranding and federation withdrawal) until its last
        parent's completion releases it. Requeue paths (eviction, failure,
        parked-work release, migration landing) come through here too as a
        defensive re-latch — completions are irrevocable under the event
        tie order, so a released task can never re-block, but the gate
        makes the invariant local instead of global."""
        if task.parents_left > 0:
            self._blocked[task.tid] = task
            task.node = -1
        else:
            self._place(task, t)

    def _xfer_times(self, task: Task) -> np.ndarray | None:
        """Per-node time to fetch the task's parent outputs over the data
        link (``bytes / link_bandwidth``; a parent's output is free on the
        node that produced it). ``None`` when the task has nothing to
        fetch — the common non-DAG case stays allocation-free."""
        if not task.parents:
            return None
        xfer = None
        for pid in task.parents:
            p = self.tasks.get(pid)
            if p is None or p.out_size <= 0.0:
                continue
            if xfer is None:
                xfer = np.zeros(self.grid.capacity)
            xfer += p.out_size / self.link_bandwidth
            if 0 <= p.output_node < xfer.size:
                xfer[p.output_node] -= p.out_size / self.link_bandwidth
        return xfer

    def _place(self, task: Task, t: float) -> None:
        """Ask the policy for a node; fall back to the least-loaded
        *feasible* active node if it answers with a virtual/failed/
        infeasible slot. The engine always enforces constraints — even
        under ``constraint_blind``, which only hides the mask from the
        policy. When every feasible node is down, the task parks on the
        first feasible slot's queue until a node rejoins (the constrained
        analogue of the total-outage park on node 0)."""
        fmask = task.feasible
        view_mask = None if (fmask is None or self.constraint_blind) \
            else fmask
        # placement latency is sampled 1-in-latency_sample
        # (deterministically): the clock-read + record pair costs a
        # sizeable fraction of a cheap placement, and per-decision stats
        # only need a representative sample, not a census — the recorded
        # sample carries the stride as its weight, so decision_stats()
        # still reports the full count. Trigger/rebalance decisions are
        # orders of magnitude rarer and stay fully timed.
        _timed = (self._tr is not None
                  and self._dec_count % self._lat_every == 0)
        if self._tr is not None:
            self._dec_count += 1
        _t0 = time.perf_counter() if _timed else 0.0
        view = self.view(t, feasible=view_mask)
        if task.parents:
            xfer = self._xfer_times(task)
            if xfer is not None:
                view = ClusterView(
                    time=view.time, grid=view.grid, loads=view.loads,
                    m_seen=view.m_seen, rng=view.rng,
                    feasible=view.feasible, xfer=xfer)
        try:
            node = self.policy.on_arrival(task.work, task.packets, view)
        except ValueError:  # e.g. positional rule with zero active power
            node = -1
        if _timed:
            self._tr.decision("place", time.perf_counter() - _t0,
                              weight=self._lat_every)
        ok = (0 <= node < self.grid.capacity and self.grid.active[node]
              and (fmask is None or fmask[node]))
        if not ok:
            allowed = (self.grid.active if fmask is None
                       else self.grid.active & fmask)
            if allowed.any():
                loads = self.loads(t)
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratio = np.where(
                        allowed,
                        loads / np.maximum(self.grid.powers, 1e-12), np.inf)
                node = int(np.argmin(ratio))
            elif fmask is not None:
                if not fmask.any():  # belt-and-braces: admission validates
                    raise InfeasibleTaskError(
                        f"task {task.tid}: constraints exclude every node")
                node = int(np.flatnonzero(fmask)[0])
            else:
                node = 0  # total outage: park until a join
        task.node = node
        task.placements.append((t, node))
        # no "dispatch" instant: per-arrival events are the telemetry
        # overhead budget's hottest line, and the placement outcome is
        # already in the trace (service span carries the node, evict/
        # migrate/fail events mark every re-placement cause)
        if self._sink is not None:
            self._sink_emit("place", t, task, node)
        self._enqueue(node, task)
        self._try_start(node, t)

    def _enqueue(self, node: int, task: Task) -> None:
        self._queues[node].append(task)
        if self._track:
            self._queued_work[node] += task.work
            tiers = self._queued_tier
            tiers[task.priority] = tiers.get(task.priority, 0.0) + task.work

    def _unqueue(self, node: int, task: Task) -> None:
        """Probe accounting for a task leaving ``node``'s queue; callers
        remove the task from the queue list themselves."""
        self._queued_work[node] -= task.work
        self._queued_tier[task.priority] -= task.work

    def _try_start(self, node: int, t: float) -> None:
        if self._running[node] is not None or not self._queues[node]:
            return
        if not self.grid.active[node]:
            return
        q = self._queues[node]
        # nonpreemptive priority service: best tier first, FIFO within tier
        i = min(range(len(q)), key=lambda j: (q[j].priority, j))
        task = q.pop(i)
        if self._track:
            self._unqueue(node, task)
        # DAG input fetch: remote parent outputs stream in before service
        # begins. The node is occupied for the whole fetch (t_attempt_start
        # marks occupation; t_start marks the service clock, so _progress
        # reads zero until the data has landed), and the locality metrics
        # charge every attempt — a restart re-fetches, exactly as it
        # re-runs (nonpreemptive schedulers checkpoint neither).
        xfer = 0.0
        if task.parents:
            remote = 0.0
            best_p, best_node = 0.0, -1
            for pid in task.parents:
                p = self.tasks.get(pid)
                if p is None or p.out_size <= 0.0:
                    continue
                if p.out_size > best_p:
                    best_p, best_node = p.out_size, p.output_node
                if p.output_node != node:
                    remote += p.out_size
            if best_node >= 0:
                if best_node == node:
                    self.metrics.locality_hits += 1
                else:
                    self.metrics.locality_misses += 1
            if remote > 0.0:
                self.metrics.dag_bytes_moved += remote
                xfer = remote / self.link_bandwidth
        task.t_start = t + xfer
        task.t_attempt_start = t
        self._running[node] = task
        # no "start" instant: the start time is the "service" span's start
        service = (task.work - task.work_done) / self.grid.powers[node]
        self._eq.push(t + xfer + service, EventKind.COMPLETION,
                      (task, node, task.token))

    def _interrupt(self, task: Task, node: int, t: float) -> None:
        """Stop a running task and discard the attempt's progress (wasted
        work); the task owes its full demand again. Leaves the node free —
        the caller decides where the task goes next."""
        if self._tr is not None and task.t_attempt_start is not None:
            self._tr.span("service", task.t_attempt_start, t, tid=task.tid,
                          cat="service",
                          args={"node": node, "interrupted": True})
        self.metrics.wasted_work += self._progress(task, node, t)
        task.t_start = None
        task.t_attempt_start = None
        task.work_done = 0.0
        task.token += 1
        self._running[node] = None
        task.node = -1

    def _strand(self, node: int, t: float) -> list[Task]:
        """Pull every task off a failed node; running restarts from scratch.
        Re-placement happens best tier first (same order as admission)."""
        stranded = list(self._queues[node])
        self._queues[node] = []
        if self._track:
            for task in stranded:
                self._unqueue(node, task)
        r = self._running[node]
        if r is not None:
            self._interrupt(r, node, t)
            r.restarts += 1
            self.metrics.restarts += 1
            stranded.append(r)
        for task in stranded:
            task.node = -1
        return sorted(stranded, key=lambda task: (task.priority, task.tid))

    def _rebalance(self, t: float) -> None:
        """Migrate queued tasks to the PSTS placement (nonpreemptive: running
        and in-flight tasks are untouched).

        Constrained tasks balance within their feasible sub-cluster:
        queued work is partitioned by feasibility signature, and each
        partition runs PSTS over the grid with infeasible nodes virtualized
        (power 0) — the paper's incomplete-grid treatment reused as the
        constraint mechanism. Unconstrained tasks balance over the full
        grid as before."""
        queued = [task for q in self._queues for task in q]
        if not queued:
            return
        groups: dict[bytes | None, list[Task]] = {}
        for task in queued:
            key = None if task.feasible is None else task.feasible.tobytes()
            groups.setdefault(key, []).append(task)
        for key, tasks in groups.items():
            if key is None:
                grid = self.grid
            else:
                fmask = tasks[0].feasible
                grid = HyperGrid(self.grid.dims,
                                 np.where(fmask, self.grid.powers, 0.0),
                                 self.grid.active & fmask)
                if grid.total_power <= 0:
                    continue  # every feasible node is down: tasks stay put
            works = np.array([task.work for task in tasks])
            nodes = np.array([task.node for task in tasks])
            res = psts_schedule(works, nodes, grid)
            for task, dst in zip(tasks, res.dest):
                dst = int(dst)
                if dst == task.node:
                    continue
                delay = task.packets / self.bandwidth
                if self._tr is not None:
                    # flight time is deterministic, so the whole span is
                    # known at departure — no begin/end bookkeeping needed
                    self._tr.span("migrate", t, t + delay, tid=task.tid,
                                  cat="migrate",
                                  args={"src": task.node, "dst": dst})
                if self._sink is not None:
                    self._sink_emit("migrate", t, task, task.node, dst)
                self._queues[task.node].remove(task)
                if self._track:
                    self._unqueue(task.node, task)
                task.node = -1
                task.migrations += 1
                self._in_flight.add(task.tid)
                self.metrics.migrations += 1
                self.metrics.moved_packets += task.packets
                self.metrics.moved_units += task.work
                self._eq.push(t + delay, EventKind.MIGRATION_ARRIVE,
                              (task, dst))

    # -- event handlers -----------------------------------------------------
    def _on_arrival(self, task: Task, t: float) -> None:
        # no "submit" instant: the submit time is the "task" span's start
        # (emitted at completion), and per-event cost here is the telemetry
        # overhead budget's hottest line
        self.metrics.observe_arrival(work=task.work)
        self.tasks[task.tid] = task
        # the pre-arrival dict is authoritative until now: parents that
        # completed before this arrival already decremented it
        task.parents_left = self._pending_parents.pop(task.tid,
                                                      task.parents_left)
        self._admit(task, t)

    def _on_completion(self, task: Task, node: int, token: int,
                       t: float) -> None:
        if task.token != token or self._running[node] is not task:
            return  # stale completion from before a restart or resize
        self._running[node] = None
        task.t_finish = t
        if task.ends_evicted:
            # the trace ended this task with an EVICT/KILL/FAIL, not a
            # FINISH: count it apart so throughput is not inflated
            self.metrics.evictions += 1
            task.evictions += 1
        # wait = arrival -> start of the attempt that finished. For an
        # unchurned task this equals response - work/power; for one whose
        # service spanned a resize it stays exact (work/current-power no
        # longer describes the realized service time)
        t_started = (task.t_attempt_start if task.t_attempt_start
                     is not None else t - task.work / self.grid.powers[node])
        self.metrics.observe_completion(
            response=t - task.t_arrive,
            wait=t_started - task.t_arrive,
            t_finish=t, tier=task.priority, work=task.work)
        if self._sink is not None:
            self._sink_emit("complete", t, task, node)
        if self._tr is not None:
            # the completed attempt's service span carries no args dict
            # (an args-free record leaves nothing GC-tracked behind); the
            # serving node rides on the task span instead, and
            # ``interrupted`` service spans are only emitted by
            # ``_interrupt``, so its absence here is unambiguous
            self._tr.span("service", t_started, t, tid=task.tid,
                          cat="service")
            args = {"work": task.work, "tier": task.priority,
                    "node": node,
                    "migrations": task.migrations,
                    "evictions": task.evictions,
                    "restarts": task.restarts}
            if task.trace_ctx is not None:
                # handed-off task: close its causal chain — the task span
                # is the child of the last WAN hop it rode in on
                args["trace_id"] = task.trace_ctx[0]
                args["span_id"] = self._tr.next_span_id()
                args["parent_id"] = task.trace_ctx[1]
            self._tr.span("task", task.t_arrive, t, tid=task.tid,
                          cat="lifecycle", args=args)
        if task.has_children:
            task.output_node = node
            self._release_children(task.tid, t)
        self._try_start(node, t)

    def _release_children(self, tid: int, t: float) -> None:
        """A parent completed: decrement each child's unfinished-parent
        count (the pre-arrival dict or the arrived task, whichever is
        authoritative) and place children whose last parent this was."""
        for cid in self._children.get(tid, ()):
            if cid in self._pending_parents:  # child not arrived yet
                self._pending_parents[cid] -= 1
                continue
            child = self.tasks.get(cid)
            if child is None or child.t_finish is not None:
                continue
            child.parents_left -= 1
            if child.parents_left <= 0 and cid in self._blocked:
                del self._blocked[cid]
                if self._tr is not None and t > child.t_arrive:
                    self._tr.span("blocked-on-parents", child.t_arrive, t,
                                  tid=cid, cat="lifecycle")
                self._place(child, t)

    def _on_eviction(self, tid: int, t: float) -> None:
        """Exogenous preemption replay: pull the task off its machine,
        discard the interrupted attempt's progress (wasted work), and
        requeue it through the normal admission path. Fires addressed to
        finished, absent (withdrawn for a WAN hand-off) or in-flight tasks
        are no-ops — the replay outran the trace's churn."""
        task = self.tasks.get(tid)
        if task is None or task.t_finish is not None:
            return
        if self._tr is not None and (task.t_start is not None
                                     or task.node >= 0):
            self._tr.instant("evict", t, tid=tid, cat="lifecycle",
                             args={"running": task.t_start is not None})
        if self._sink is not None and (task.t_start is not None
                                       or task.node >= 0):
            self._sink_emit("evict", t, task, task.t_start is not None)
        if task.t_start is not None:  # running: the attempt is lost
            node = task.node
            self._interrupt(task, node, t)
            task.evictions += 1
            self.metrics.evictions += 1
            self._admit(task, t)
            self._try_start(node, t)
        elif task.node >= 0:  # queued: requeued through the policy
            self._queues[task.node].remove(task)
            if self._track:
                self._unqueue(task.node, task)
            task.node = -1
            task.evictions += 1
            self.metrics.evictions += 1
            self._admit(task, t)
        # else: mid-migration — it is on no machine; nothing to reclaim

    def _on_resize(self, node: int, fraction: float, t: float) -> None:
        """Capacity change in place (machine_events UPDATE): the node's
        power becomes ``fraction`` of its base power. A running task banks
        its progress and continues at the new rate — unlike an eviction,
        the machine kept the task. A non-positive fraction is a removal."""
        if node >= self._powers_full.size or node < 0:
            return
        if fraction <= 0:
            self._on_fail(node, t)
            return
        new_power = self._base_powers[node] * float(fraction)
        self._powers_full[node] = new_power  # what a later join restores
        if not self.grid.active[node]:
            return  # applies when the node rejoins
        self.metrics.resizes += 1
        if self._tr is not None:
            self._tr.instant("resize", t, pid=PID_NODES, tid=node,
                             cat="node", args={"fraction": float(fraction)})
        r = self._running[node]
        if r is not None:
            if r.t_start <= t:  # bank progress at the old rate first
                r.work_done = self._progress(r, node, t)
                r.t_start = t
            # else: still fetching DAG inputs — the transfer end time is
            # set by the link, not the node's power, so t_start stands
            r.token += 1
        powers = self.grid.powers.copy()
        powers[node] = new_power
        self.grid = HyperGrid(self.grid.dims, powers, self.grid.active)
        if r is not None:
            service = (r.work - r.work_done) / self.grid.powers[node]
            self._eq.push(max(r.t_start, t) + service, EventKind.COMPLETION,
                          (r, node, r.token))

    def _on_migration_arrive(self, task: Task, dst: int, t: float) -> None:
        self._in_flight.discard(task.tid)
        if self._tr is not None and dst < 0:
            # an injected hand-off from another cluster (local migrations
            # record their full span at departure — the flight time is
            # deterministic, so there is nothing left to learn on arrival)
            if task.trace_ctx is not None:
                trace_id, parent = task.trace_ctx
                sid = self._tr.next_span_id()
                self._tr.instant("land", t, tid=task.tid, cat="migrate",
                                 args={"trace_id": trace_id,
                                       "span_id": sid,
                                       "parent_id": parent})
                task.trace_ctx = (trace_id, sid)
            else:
                self._tr.instant("land", t, tid=task.tid, cat="migrate")
        if dst < 0 or not self.grid.active[dst]:
            # dst < 0: an injected federation hand-off, placed by the local
            # policy on landing; otherwise the destination died in flight
            self._admit(task, t)
            return
        task.node = dst
        task.placements.append((t, dst))
        self._enqueue(dst, task)
        self._try_start(dst, t)

    def _on_fail(self, node: int, t: float) -> None:
        if not self.grid.active[node]:
            return
        self.metrics.failures += 1
        if self._tr is not None:
            self._tr.instant("fail", t, pid=PID_NODES, tid=node, cat="node")
        self.grid = self.grid.fail(node)
        for task in self._strand(node, t):
            self._admit(task, t)

    def _on_join(self, node: int, t: float) -> None:
        if self.grid.active[node] or node >= self._powers_full.size:
            return
        self.metrics.joins += 1
        if self._tr is not None:
            self._tr.instant("join", t, pid=PID_NODES, tid=node, cat="node")
        powers = self.grid.powers.copy()
        active = self.grid.active.copy()
        powers[node] = self._powers_full[node]
        active[node] = True
        self.grid = HyperGrid(self.grid.dims, powers, active)
        # release work parked on still-inactive nodes (possible only after a
        # total outage, when the placement fallback had nowhere active)
        for nd in np.flatnonzero(~self.grid.active):
            if self._queues[nd]:
                parked, self._queues[nd] = self._queues[nd], []
                for task in parked:
                    if self._track:
                        self._unqueue(nd, task)
                    task.node = -1
                    self._admit(task, t)
        self._try_start(node, t)

    def _on_trigger_eval(self, t: float) -> None:
        queued = sum(len(q) for q in self._queues)
        if queued and self.grid.total_power > 0:
            loads = self.loads(t)
            targets = loads.sum() * self.grid.gamma
            excess = float(np.maximum(loads - targets, 0.0).sum())
            mean_packets = np.mean(
                [task.packets for q in self._queues for task in q])
            works = [task.work for q in self._queues for task in q]
            est = excess * mean_packets / max(np.mean(works), 1e-12)
            _t0 = time.perf_counter() if self._tr is not None else 0.0
            dec = self.policy.wants_rebalance(self.view(t), queued, est)
            if self._tr is not None:
                self._tr.decision("trigger", time.perf_counter() - _t0)
            if dec is not None:
                self.metrics.trigger_evals += 1
                if self._sink is not None:
                    self._sink_emit("trigger", t, bool(dec.trigger))
                if self._anom is not None:
                    for rec in self._anom.observe_trigger(
                            t, bool(dec.trigger)):
                        if self._sink is not None:
                            self._sink_emit("alert", t, rec)
                if self._mon is not None:
                    self._mon.record(
                        t, dec, floor=float(getattr(self.policy, "floor",
                                                    0.0)),
                        moved_packets=est)
                if self._tr is not None:
                    self._tr.instant(
                        "trigger_fire" if dec.trigger else "trigger_skip",
                        t, pid=PID_SCHED, tid=0, cat="trigger",
                        args={"fired": bool(dec.trigger)})
                if dec.trigger:
                    self.metrics.trigger_fires += 1
                    _t1 = (time.perf_counter() if self._tr is not None
                           else 0.0)
                    self._rebalance(t)
                    if self._tr is not None:
                        self._tr.decision("rebalance",
                                          time.perf_counter() - _t1)
        # re-arm only while there is work left to schedule
        if self._outstanding() or self._eq.pending(
                EventKind.ARRIVAL, EventKind.MIGRATION_ARRIVE,
                EventKind.COMPLETION):
            self._eq.push(t + self.trigger_period, EventKind.TRIGGER_EVAL)

    def _on_probe(self, t: float) -> None:
        """Sample the probe series and re-arm on its cadence; purely
        observational, mirrors the trigger chain's arming rules."""
        self._probe.observe(self, t)
        if self._anom is not None:
            for rec in self._anom.observe(self, t):
                if self._sink is not None:
                    self._sink_emit("alert", t, rec)
        if self._outstanding() or self._eq.pending(
                EventKind.ARRIVAL, EventKind.MIGRATION_ARRIVE,
                EventKind.COMPLETION):
            self._eq.push(t + self._probe.every, EventKind.PROBE_SAMPLE)

    def probe_snapshot(self, t: float) -> dict:
        """Raw fields a :class:`repro_torch.obs.ProbeSeries` samples: per-node
        load, queue depth (queued + running count), per-tier queued work,
        and live-task counters. Arrays are capacity-length (virtual slots
        included, always zero).

        O(nodes) when the incremental accounting is live (probes enabled
        at construction): per-node load = clamped queued-work accumulator
        plus each running task's remaining work. The O(tasks) fallback
        keeps ad-hoc sampling of un-probed runtimes working."""
        queue_depth = [len(q) + (self._running[n] is not None)
                       for n, q in enumerate(self._queues)]
        if self._track:
            # pure-python floats throughout: numpy scalar arithmetic on
            # 16-element state costs ~10us a sample. Clamp the ~1e-13
            # incremental residue — a phantom load on a powerless slot
            # would read as stranded work (inf imbalance) downstream
            node_load = [w if w > 1e-9 else 0.0 for w in self._queued_work]
            powers = self.grid.powers.tolist()
            for n, r in enumerate(self._running):
                if r is not None:
                    done = r.work_done + (t - r.t_start) * powers[n]
                    w = r.work
                    if done < 0.0:
                        done = 0.0
                    elif done > w:
                        done = w
                    node_load[n] += w - done
            tier_work = {tier: w for tier, w in self._queued_tier.items()
                         if w > 1e-9}
        else:
            node_load = self.loads(t)
            tier_work = {}
            for q in self._queues:
                for task in q:
                    tier_work[task.priority] = (
                        tier_work.get(task.priority, 0.0) + task.work)
        return {
            "node_load": node_load,
            "queue_depth": queue_depth,
            "tier_work": tier_work,
            "in_flight": len(self._in_flight),
            "queued_tasks": sum(len(q) for q in self._queues),
            "blocked_tasks": len(self._blocked),
        }

    # -- federation hand-off ------------------------------------------------
    def queued_tasks(self) -> list[Task]:
        """Snapshot of queued (not running, not in-flight) tasks in node
        order — the set a federation balancer may withdraw."""
        return [task for q in self._queues for task in q]

    def withdraw(self, task: Task) -> None:
        """Remove a queued task for an external hand-off (WAN migration).
        The task stops existing here; inject it elsewhere to conserve it."""
        if task.node < 0 or task not in self._queues[task.node]:
            raise ValueError(f"task {task.tid} is not queued here")
        self._queues[task.node].remove(task)
        if self._track:
            self._unqueue(task.node, task)
        self.tasks.pop(task.tid, None)
        task.node = -1

    def extract_evictions(self, tid: int) -> list[float]:
        """Remove this task's still-pending exogenous eviction rows and
        return their times, in order. A WAN hand-off re-targets them to
        the member that now holds the task — left here they would fire as
        silent no-ops and churn replay would under-evict."""
        return [ev.time for ev in self._eq.extract(
            EventKind.EVICTION, lambda payload: payload == tid)]

    def requeue_pending(self) -> bool:
        """True while queued work exists or events that can still (re)queue
        work are scheduled — arrivals, hand-off landings, evictions and
        capacity churn. A federation stops arming exchange evaluations once
        every member reports False: tasks already running to completion
        can never become balancer-movable again."""
        if any(self._queues):
            return True
        return bool(self._eq.pending(
            EventKind.ARRIVAL, EventKind.MIGRATION_ARRIVE,
            EventKind.EVICTION, EventKind.NODE_FAIL, EventKind.NODE_RESIZE))

    def submit(self, task: Task, t: float | None = None, *,
               arrival: bool = True, evictions=()) -> None:
        """Deliver one task — the canonical live-admission verb.

        ``arrival=True`` (the default) admits a *new* task at time ``t``
        (default: now): it counts as a local arrival, exactly as if
        ``schedule_workload`` had known about it upfront. DAG parents are
        wired incrementally (parents already finished count as released),
        and ``evictions`` schedules exogenous requeue events addressed to
        this task (times already in the past are dropped — an offline
        replay would have fired them before the arrival as no-ops).

        ``arrival=False`` delivers a federation hand-off: the local policy
        places it on landing and it does not count as a local arrival —
        the source cluster already observed it.

        The trigger/probe chains revive if they have died out idle. For
        arrivals they re-arm on the absolute ``k * period`` grid — the
        same phase an offline replay evaluates on, which is what makes
        incremental feeding reproduce offline metrics exactly. Hand-offs
        keep the legacy ``t + period`` phase (they have no offline twin)."""
        t = self._now if t is None else float(t)
        if t < self._now:
            raise ValueError(f"cannot submit at t={t}: clock is at "
                             f"{self._now}")
        if not arrival:
            self.tasks[task.tid] = task
            task.node = -1
            self._eq.push(t, EventKind.MIGRATION_ARRIVE, (task, -1))
            # revive the trigger chain: an idle member stops re-arming, but
            # injected work must still be eligible for rebalancing
            if (self.policy.uses_trigger and self.trigger_period > 0
                    and not self._eq.pending(EventKind.TRIGGER_EVAL)):
                self._eq.push(t + self.trigger_period,
                              EventKind.TRIGGER_EVAL)
            if (self._probe is not None
                    and not self._eq.pending(EventKind.PROBE_SAMPLE)):
                self._eq.push(t + self._probe.every, EventKind.PROBE_SAMPLE)
            return
        if task.tid in self.tasks:
            raise ValueError(f"task id {task.tid} already admitted")
        if task.parents:
            # incremental DAG wiring: count + register only the parents
            # still unfinished; completions between now and the arrival
            # decrement through _children like the offline pre-wired path
            left = 0
            for pid in task.parents:
                p = self.tasks.get(pid)
                if p is not None and p.t_finish is not None:
                    continue
                left += 1
                self._children.setdefault(pid, []).append(task.tid)
            if left:
                self._pending_parents[task.tid] = left
        self._eq.push(t, EventKind.ARRIVAL, task)
        for te in evictions:
            te = float(te)
            if te >= self._now:
                self._eq.push(te, EventKind.EVICTION, task.tid)
        self._arm_chains()

    def inject(self, task: Task, t: float) -> None:
        """Deprecated spelling of ``submit(task, t, arrival=False)``."""
        warnings.warn("ClusterRuntime.inject() is deprecated; use "
                      "submit(task, t, arrival=False)", DeprecationWarning,
                      stacklevel=2)
        self.submit(task, t, arrival=False)

    def _arm_chains(self) -> None:
        """Revive dead trigger/probe chains on the absolute grid: the next
        ``k * period`` strictly after now. An offline replay arms once at
        ``period`` and re-arms ``t + period`` forever (future arrivals keep
        the chain alive), so its evaluations land exactly on this grid;
        evaluations the online chain missed while dead had empty queues and
        touch no metric, so grid re-arming restores exact equivalence."""
        period = self.trigger_period
        if (self.policy.uses_trigger and period > 0
                and not self._eq.pending(EventKind.TRIGGER_EVAL)):
            k = math.floor(self._now / period + 1e-9) + 1
            self._eq.push(k * period, EventKind.TRIGGER_EVAL)
        if (self._probe is not None
                and not self._eq.pending(EventKind.PROBE_SAMPLE)):
            every = self._probe.every
            k = math.floor(self._now / every + 1e-9) + 1
            self._eq.push(k * every, EventKind.PROBE_SAMPLE)

    def schedule_eviction(self, tid: int, t: float) -> None:
        """Schedule one exogenous eviction addressed by task id. Fires
        before the task arrives (or after it finished) are no-ops, so a
        whole trace's eviction stream can be installed upfront — in row
        order, preserving offline tie-breaking — while arrivals stream."""
        self._eq.push(float(t), EventKind.EVICTION, int(tid))

    def post_failure(self, node: int, t: float | None = None) -> None:
        """Schedule a node failure at ``t`` (default: now)."""
        self._eq.push(self._now if t is None else float(t),
                      EventKind.NODE_FAIL, int(node))

    def post_join(self, node: int, t: float | None = None) -> None:
        """Schedule a node (re)join at ``t`` (default: now)."""
        self._eq.push(self._now if t is None else float(t),
                      EventKind.NODE_JOIN, int(node))

    def post_resize(self, node: int, fraction: float,
                    t: float | None = None) -> None:
        """Schedule a capacity resize at ``t`` (default: now)."""
        self._eq.push(self._now if t is None else float(t),
                      EventKind.NODE_RESIZE, (int(node), float(fraction)))

    def _resolve_feasibility(self, workload) -> list | None:
        """Per-task feasibility masks over grid slots, or ``None`` for
        unconstrained workloads. Identical masks share one array so
        rebalance grouping (`tobytes` keys) and memory stay tight."""
        constraints = getattr(workload, "constraints", None)
        if constraints is None or constraints.empty:
            return None
        if self.attr_matrix is None:
            raise InfeasibleTaskError(
                f"workload tasks carry placement constraints over "
                f"attributes {sorted(constraints.attr_names)} but the "
                f"cluster declares no node attrs; pass node_attrs= "
                f"(lab: ClusterSpec(attrs={{...}}))")
        phys = workload.feasibility(self.attr_names, self.attr_matrix)
        cap = self.grid.capacity
        padded = np.zeros((phys.shape[0], cap), dtype=bool)
        padded[:, :phys.shape[1]] = phys
        cache: dict[bytes, np.ndarray] = {}
        out = []
        for i in range(phys.shape[0]):
            if phys[i].all():
                out.append(None)  # unconstrained task: no mask at all
                continue
            key = padded[i].tobytes()
            if key not in cache:
                cache[key] = padded[i].copy()
            out.append(cache[key])
        return out

    # -- driving the clock --------------------------------------------------
    def schedule_workload(self, workload: Workload, *, failures=(),
                          joins=(), resizes=(), tid_base: int = 0) -> None:
        """Queue a workload's arrivals and fault events. ``tid_base``
        offsets task ids so several workloads (federation members) share one
        global id space. ``resizes`` are ``(time, node, fraction)`` capacity
        changes (machine_events UPDATE rows).

        Trace workloads (:class:`repro_torch.traces.TraceSchema`)
        additionally carry priorities and constraints: same-instant arrivals are admitted best
        tier first (the event queue breaks timestamp ties by push order),
        and each constrained task gets its feasibility mask resolved here,
        once, against the cluster attribute table — a task no node can ever
        satisfy is a loud :class:`InfeasibleTaskError` before the clock
        starts, not a hang mid-run. A trace's eviction rows become
        :class:`EventKind.EVICTION` events addressed by task id, and its
        ``ends_evicted`` flags ride on the tasks."""
        priority = np.asarray(
            getattr(workload, "priority", None)
            if getattr(workload, "priority", None) is not None
            else np.zeros(workload.m), dtype=np.int64)
        ends_evicted = np.asarray(
            getattr(workload, "ends_evicted", None)
            if getattr(workload, "ends_evicted", None) is not None
            else np.zeros(workload.m, dtype=bool), dtype=bool)
        masks = self._resolve_feasibility(workload)
        # DAG wiring: per-task parent tuples (global ids via tid_base), the
        # pre-arrival pending-parent counts, the parent -> children map the
        # release frontier walks at completions, and the workload's
        # critical-path lower bound (the cp_stretch denominator)
        dag = getattr(workload, "dag", None)
        if dag is not None and dag.empty:
            dag = None
        parents_of = has_child = None
        if dag is not None:
            parents_of = dag.parents_of()
            has_child = np.zeros(dag.m, dtype=bool)
            if dag.k:
                has_child[dag.parent] = True
            for c, p in zip(dag.child.tolist(), dag.parent.tolist()):
                self._children.setdefault(tid_base + p, []).append(
                    tid_base + c)
            for i, ps in enumerate(parents_of):
                if ps:
                    self._pending_parents[tid_base + i] = len(ps)
            self.metrics.cp_lower_bound = max(
                self.metrics.cp_lower_bound,
                dag.cp_lower_bound(workload.works, self._base_powers,
                                   workload.t_arrive))
        # stable (t, tier) order: priority decides admission within a batch
        order = np.lexsort((priority, workload.t_arrive))
        for i in map(int, order):
            self._eq.push(workload.t_arrive[i], EventKind.ARRIVAL,
                          Task(tid=tid_base + i,
                               t_arrive=float(workload.t_arrive[i]),
                               work=float(workload.works[i]),
                               packets=float(workload.packets[i]),
                               priority=int(priority[i]),
                               ends_evicted=bool(ends_evicted[i]),
                               feasible=None if masks is None
                               else masks[i],
                               parents=() if parents_of is None else tuple(
                                   tid_base + p for p in parents_of[i]),
                               has_children=bool(has_child[i])
                               if has_child is not None else False,
                               out_size=float(dag.out_size[i])
                               if dag is not None else 0.0))
        evictions = getattr(workload, "evictions", None)
        if evictions is not None and not evictions.empty:
            for j in range(evictions.k):
                self.schedule_eviction(tid_base + int(evictions.task[j]),
                                       float(evictions.time[j]))
        self.schedule_faults(failures=failures, joins=joins,
                             resizes=resizes)
        if (self.policy.uses_trigger and self.trigger_period > 0
                and not self._eq.pending(EventKind.TRIGGER_EVAL)):
            self._eq.push(self.trigger_period, EventKind.TRIGGER_EVAL)
        if (self._probe is not None
                and not self._eq.pending(EventKind.PROBE_SAMPLE)):
            self._eq.push(self._probe.every, EventKind.PROBE_SAMPLE)

    def schedule_faults(self, *, failures=(), joins=(), resizes=()) -> None:
        """Queue machine events: ``failures``/``joins`` are ``(time, node)``
        sequences, ``resizes`` are ``(time, node, fraction)``."""
        for t, node in failures:
            self.post_failure(node, t)
        for t, node in joins:
            self.post_join(node, t)
        for t, node, fraction in resizes:
            self.post_resize(node, fraction, t)

    def _dispatch(self, ev) -> None:
        if ev.kind == EventKind.ARRIVAL:
            self._on_arrival(ev.payload, ev.time)
        elif ev.kind == EventKind.COMPLETION:
            self._on_completion(*ev.payload, ev.time)
        elif ev.kind == EventKind.EVICTION:
            self._on_eviction(ev.payload, ev.time)
        elif ev.kind == EventKind.MIGRATION_ARRIVE:
            self._on_migration_arrive(*ev.payload, ev.time)
        elif ev.kind == EventKind.NODE_FAIL:
            self._on_fail(ev.payload, ev.time)
        elif ev.kind == EventKind.NODE_JOIN:
            self._on_join(ev.payload, ev.time)
        elif ev.kind == EventKind.NODE_RESIZE:
            self._on_resize(*ev.payload, ev.time)
        elif ev.kind == EventKind.TRIGGER_EVAL:
            self._on_trigger_eval(ev.time)
        elif ev.kind == EventKind.PROBE_SAMPLE:
            self._on_probe(ev.time)

    def advance(self, until: float | None = None, *,
                max_events: int | None = None, strict: bool = False) -> int:
        """Advance the clock in one bounded micro-step — the session
        primitive everything else is built on.

        Processes events in timestamp order while ``peek <= until``
        (``until=None`` runs the queue dry) and at most ``max_events`` of
        them; returns the number processed. Unprocessed events stay queued
        for the next call, so a service loop can interleave ``advance``
        with live ``submit``/``withdraw`` at any granularity. With
        ``strict=True`` exhausting the budget raises instead of returning
        (the legacy ``run``/``step_until`` contract)."""
        n_events = 0
        while self._eq and (until is None
                            or self._eq.peek_time() <= until):
            if max_events is not None and n_events >= max_events:
                if strict:
                    raise RuntimeError(
                        f"event budget exhausted ({max_events})")
                return n_events
            ev = self._eq.pop()
            n_events += 1
            self._now = ev.time
            self._dispatch(ev)
        if until is not None:
            self._now = max(self._now, until)
        return n_events

    def drain(self, *, max_events: int = 2_000_000) -> Metrics:
        """Run the event queue dry and return the metrics."""
        self.advance(max_events=max_events, strict=True)
        return self.metrics

    def open_session(self):
        """Open a session over this runtime — the ``feed / submit /
        advance / drain / close`` lifecycle handle of the JAX package's
        ``repro.serve.session.Session``."""
        raise NotImplementedError(
            "ClusterRuntime.open_session (the serve.session lifecycle "
            "handle) comes with the serve slice of the port")

    def step_until(self, t: float, *, max_events: int = 2_000_000) -> int:
        """Deprecated spelling of ``advance(until=t, ...)``."""
        warnings.warn("ClusterRuntime.step_until() is deprecated; use "
                      "advance(until=t)", DeprecationWarning, stacklevel=2)
        return self.advance(until=t, max_events=max_events, strict=True)

    def run(self, workload: Workload, *, failures=(), joins=(), resizes=(),
            horizon: float | None = None, max_events: int = 2_000_000
            ) -> Metrics:
        """Run to completion (or ``horizon``). ``failures``/``joins`` are
        ``(time, node)`` sequences; ``resizes`` are ``(time, node,
        fraction)`` capacity changes.

        Convenience composition of the session primitives: equivalent to
        ``schedule_workload(...)`` followed by ``advance(until=horizon)``
        / ``drain()``."""
        self.schedule_workload(workload, failures=failures, joins=joins,
                               resizes=resizes)
        if horizon is None:
            return self.drain(max_events=max_events)
        self.advance(until=horizon, max_events=max_events, strict=True)
        return self.metrics


def run_policy(policy: str | Policy, workload: Workload, powers, *,
               failures=(), joins=(), resizes=(), **runtime_kwargs
               ) -> Metrics:
    """Deprecated convenience: one policy, one workload, fresh runtime.

    Prefer ``repro_torch.lab.run`` for declarative scenarios, or the
    session verbs (``submit``/``advance``/``drain``) for incremental use."""
    warnings.warn("run_policy() is deprecated; use repro_torch.lab.run() or "
                  "the ClusterRuntime session API (submit/advance/drain)",
                  DeprecationWarning, stacklevel=2)
    rt = ClusterRuntime(powers, policy, **runtime_kwargs)
    return rt.run(workload, failures=failures, joins=joins,
                  resizes=resizes)
