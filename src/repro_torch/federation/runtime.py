"""Multi-cluster runtime: N event engines exchanging work over WAN links.

Each member is one :class:`~repro_torch.runtime.runtime.ClusterRuntime` (full
event-driven fidelity: FIFO servers, faults, in-cluster PSTS triggers) —
or, recursively, another :class:`FederatedRuntime`: the paper's recursion
applied per federation level (racks -> clusters -> regions), with the
positional rule choosing a member at every layer a task crosses.

Two driving modes (``Federation.mode``):

* ``async`` (the default): a federation-wide event heap of timestamped
  :class:`WanMessage` landings and exchange evaluations. A WAN hand-off
  lands at the *destination's* local event horizon — only the destination
  advances to the landing instant — and exchange evaluations stop arming
  once no member can (re)queue balancer-movable work, so a long drain tail
  costs no federation-level work at all. ``advance(until)`` stops at
  arbitrary times.
* ``lockstep``: the conformance-reference epoch stepper — every member
  advances to each ``exchange_period`` boundary before the balancer runs.

Two exchange policies (``Federation.exchange``): positional ``push``
(overloaded members send toward the scan-chosen deficit, the paper's rule
one level up) and pull-based ``stealing`` (underloaded members request work
from reachable overloaded peers — ``balancer.choose_victim`` — bounded by
link cost and the same reservation-style admission margin).

Conservation is checked at every exchange evaluation (scheduled = completed
+ queued + running + in flight, across all members, nested federations and
the WAN) and at the end (all tasks done, moved work sent equals work
landed), so a federation bug cannot silently duplicate or leak tasks.
:meth:`FederatedRuntime.work_census` extends the audit to work units.

Churn replay: each member replays its own trace eviction stream and
machine_events schedule as ordinary events in its queue. Eviction events
are addressed by task id, so when a task is handed off over the WAN its
still-pending eviction rows are *re-targeted* to the member that now holds
it (rows the transfer itself overtakes are counted as dropped) — churn
replay stays conservative across hand-offs.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

import numpy as np

from ..lab.specs import resolve_fault_schedule
from ..obs import build_instruments
from ..runtime.metrics import Metrics
from ..runtime.runtime import ClusterRuntime
from .balancer import ExchangeStats, admit, choose_destination, choose_victim
from .specs import Federation

__all__ = ["FederatedRuntime", "FederationReport", "WanMessage",
           "aggregate_metrics"]

_TINY = 1e-9

# heap ranks at equal timestamps: landings resolve before exchange
# evaluations, so an evaluation sees the work that just arrived
_RANK_WAN = 0
_RANK_EVAL = 1


def aggregate_metrics(members: list[Metrics]) -> Metrics:
    """One Metrics over every member: counters sum, makespan is the max,
    response/wait distributions concatenate (so mean/P99 are exact over the
    federation, not averages of member averages)."""
    agg = Metrics()
    for m in members:
        agg.arrived += m.arrived
        agg.completed += m.completed
        agg.migrations += m.migrations
        agg.moved_packets += m.moved_packets
        agg.moved_units += m.moved_units
        agg.trigger_evals += m.trigger_evals
        agg.trigger_fires += m.trigger_fires
        agg.restarts += m.restarts
        agg.failures += m.failures
        agg.joins += m.joins
        agg.resizes += m.resizes
        agg.evictions += m.evictions
        agg.admitted_work += m.admitted_work
        agg.completed_work += m.completed_work
        agg.wasted_work += m.wasted_work
        agg.locality_hits += m.locality_hits
        agg.locality_misses += m.locality_misses
        agg.dag_bytes_moved += m.dag_bytes_moved
        # each member's bound is a lower bound on its own finish; the
        # federation cannot finish before its slowest member could
        agg.cp_lower_bound = max(agg.cp_lower_bound, m.cp_lower_bound)
        agg.makespan = max(agg.makespan, m.makespan)
        agg.responses.extend(m.responses)
        agg.waits.extend(m.waits)
    return agg


@dataclass(frozen=True)
class WanMessage:
    """One task in flight over a WAN link: lands at ``t_land`` on member
    ``dst``'s local event horizon. Re-targeted eviction times ride along
    so churn replay follows the task."""

    t_land: float
    src: int
    dst: int
    task: object
    evictions: tuple = ()
    stolen: bool = False


@dataclass
class FederationReport:
    """What one federated run produced."""

    aggregate: Metrics
    members: list[Metrics]
    wan: ExchangeStats
    epochs: int


class FederatedRuntime:
    """N member engines (clusters or nested federations) exchanging work
    over WAN links, driven asynchronously or in lockstep epochs."""

    def __init__(self, federation: Federation, *, tid_base: int = 0,
                 _ibox: list | None = None):
        self.federation = federation
        self.mode = federation.mode
        n = federation.n_members
        self.links = {(lk.src, lk.dst): lk
                      for lk in federation.topology.resolve(n)}
        self.runtimes: list = []
        # per-member telemetry (tracer/probe/monitor trio per cluster);
        # nested federations carry their own instruments internally. The
        # shared ``_ibox`` counter hands every leaf a federation-unique
        # tracer instance (span-id high bits; 0 stays "standalone").
        self.instruments = []
        self._ibox = [0] if _ibox is None else _ibox
        self._scheduled = 0
        base = tid_base
        for member in federation.members:
            if getattr(member, "is_federation", False):
                ins = build_instruments(None)
                rt = FederatedRuntime(member, tid_base=base,
                                      _ibox=self._ibox)
                count = rt._scheduled
            else:
                ins = build_instruments(member.obs)
                self._ibox[0] += 1
                if ins.tracer is not None:
                    ins.tracer.instance = self._ibox[0]
                rt = ClusterRuntime(
                    member.cluster.resolve_powers(), member.policy.name,
                    d=member.cluster.d,
                    trigger_period=member.policy.trigger_period,
                    bandwidth=member.cluster.bandwidth,
                    link_bandwidth=member.cluster.link_bandwidth,
                    seed=member.engine_seed,
                    policy_kwargs=dict(member.policy.params),
                    node_attrs=member.cluster.resolve_attrs(),
                    constraint_blind=member.policy.constraint_mode
                    == "blind",
                    **ins.runtime_kwargs())
                wl = member.workload.materialize(member.seed)
                # each member replays its own churn: declared faults merged
                # with its trace's machine_events, and the trace's eviction
                # stream scheduled inside schedule_workload
                failures, joins, resizes = resolve_fault_schedule(member)
                rt.schedule_workload(wl, failures=failures, joins=joins,
                                     resizes=resizes, tid_base=base)
                count = wl.m
            base += count
            self._scheduled += count
            self.instruments.append(ins)
            self.runtimes.append(rt)
        self.wan_stream: list[dict] | None = (
            [] if (any(ins.any for ins in self.instruments)
                   or any(isinstance(rt, FederatedRuntime)
                          and rt.wan_stream is not None
                          for rt in self.runtimes))
            else None)
        self.stats = ExchangeStats()
        self._t = 0.0
        self._epochs = 0
        # (t_land, dst, work) for WAN transfers not yet landed — counted
        # into the destination's effective load so a pass cannot oversend
        self._wan_inflight: list[tuple[float, int, float]] = []
        # tid -> work for every task that ever crossed the WAN (a task
        # relayed twice appears once: conservation is about existence)
        self._sent: dict[int, float] = {}
        # async engine state: one heap of (t, rank, seq, WanMessage|None)
        # where None is an exchange evaluation on the k*period grid
        self._heap: list = []
        self._hseq = 0
        self._msgs_pending = 0
        self._evals_pending = 0
        if self.mode == "async":
            self._arm_eval(0.0)

    # -- member views --------------------------------------------------------
    def _leaf_runtimes(self):
        for rt in self.runtimes:
            if isinstance(rt, FederatedRuntime):
                yield from rt._leaf_runtimes()
            else:
                yield rt

    def _named_leaves(self, prefix: str = ""):
        for k, rt in enumerate(self.runtimes):
            name = f"{prefix}m{k}"
            if isinstance(rt, FederatedRuntime):
                yield from rt._named_leaves(prefix=name + ".")
            else:
                yield name, rt

    def _named_instruments(self, prefix: str = ""):
        for k, (ins, rt) in enumerate(zip(self.instruments, self.runtimes)):
            name = f"{prefix}m{k}"
            if isinstance(rt, FederatedRuntime):
                yield from rt._named_instruments(prefix=name + ".")
            else:
                yield name, ins

    def _owning_leaf(self, task):
        for leaf in self._leaf_runtimes():
            if leaf.tasks.get(task.tid) is task:
                return leaf
        return None

    def _any_tracer(self, k: int):
        rt = self.runtimes[k]
        if isinstance(rt, FederatedRuntime):
            for leaf in rt._leaf_runtimes():
                if leaf._tr is not None:
                    return leaf._tr
            return None
        return self.instruments[k].tracer

    def total_load(self, t: float) -> float:
        """Outstanding work at ``t`` summed over members plus this
        federation's own in-flight WAN transfers — the one number an
        enclosing federation's balancer sees for this member."""
        inner = sum(rt.total_load(t) for rt in self.runtimes)
        return float(inner + sum(w for tl, _, w in self._wan_inflight
                                 if tl > t))

    @property
    def total_power(self) -> float:
        return float(sum(rt.total_power for rt in self.runtimes))

    @property
    def metrics(self) -> Metrics:
        """Aggregate Metrics over every member (computed on demand)."""
        return aggregate_metrics([rt.metrics for rt in self.runtimes])

    @property
    def tasks(self) -> dict:
        """Union task table over every leaf (tids are federation-unique)."""
        out: dict = {}
        for leaf in self._leaf_runtimes():
            out.update(leaf.tasks)
        return out

    def queued_tasks(self) -> list:
        """Every queued (not running, not in-flight) task, member order —
        the set an enclosing federation's balancer may withdraw."""
        out: list = []
        for rt in self.runtimes:
            out.extend(rt.queued_tasks())
        return out

    def extract_evictions(self, tid: int) -> list[float]:
        for leaf in self._leaf_runtimes():
            evictions = leaf.extract_evictions(tid)
            if evictions:
                return evictions
        return []

    # -- balancing -----------------------------------------------------------
    def _member_loads(self, t: float) -> np.ndarray:
        """Per-member effective load at ``t``: outstanding work plus the
        in-flight WAN work already committed to each destination (pruning
        transfers that have landed by now)."""
        self._wan_inflight = [(tl, d, w) for tl, d, w in self._wan_inflight
                              if tl > t]
        loads = np.array([rt.total_load(t) for rt in self.runtimes])
        for _, dst, work in self._wan_inflight:
            loads[dst] += work
        return loads

    def _exchange(self, t: float) -> None:
        """One top-level balancing pass at evaluation instant ``t``."""
        if self.federation.exchange == "stealing":
            self._steal_pass(t)
        else:
            self._push_pass(t)

    def _movable(self, task) -> bool:
        if task.feasible is not None:
            # placement-constrained tasks are pinned to their member: the
            # feasibility mask is resolved against the source cluster's
            # attribute table and node count
            return False
        if task.parents or task.has_children:
            # DAG tasks are pinned too: parent completions release
            # children inside the owning member's frontier, and a parent
            # completing elsewhere would strand its blocked children
            return False
        return True

    def _push_pass(self, t: float) -> None:
        n = len(self.runtimes)
        loads = self._member_loads(t)
        powers = np.array([rt.total_power for rt in self.runtimes])
        total_power = powers.sum()
        if total_power <= 0:
            return
        fair = powers / total_power * loads.sum()
        # most-overloaded sources first, so the worst hotspot gets first
        # claim on the reachable deficit
        order = np.argsort(-(loads - fair))
        for src in map(int, order):
            surplus = loads[src] - fair[src]
            if surplus <= _TINY:
                break
            reachable = np.zeros(n, dtype=bool)
            for dst in range(n):
                if (src, dst) in self.links:
                    reachable[dst] = True
            if not reachable.any():
                continue
            rt = self.runtimes[src]
            # withdraw from the back of the FIFO order: the tasks that
            # would wait longest locally lose the least by travelling
            for task in reversed(rt.queued_tasks()):
                if surplus <= _TINY:
                    break
                if not self._movable(task):
                    continue
                dst = choose_destination(loads, powers, reachable,
                                         task.work)
                if dst < 0:
                    # this task is too big for every reachable deficit —
                    # a smaller one further up the queue may still travel
                    continue
                link = self.links[(src, dst)]
                delay = link.delay(task.packets)
                if not admit(loads[src], powers[src], loads[dst],
                             powers[dst], task.work, delay,
                             self.federation.admission_margin):
                    self.stats.rejected += 1
                    continue
                self._move(task, src, dst, t, delay)
                loads[src] -= task.work
                loads[dst] += task.work
                surplus -= task.work

    def _steal_pass(self, t: float) -> None:
        """Pull-based exchange: members below their global fair share
        request work from reachable overloaded peers, hungriest thief
        first, bounded by the thief's deficit, the victim's surplus and
        the same admission margin as push."""
        n = len(self.runtimes)
        loads = self._member_loads(t)
        powers = np.array([rt.total_power for rt in self.runtimes])
        total_power = powers.sum()
        if total_power <= 0:
            return
        fair = powers / total_power * loads.sum()
        margin = self.federation.admission_margin
        order = np.argsort(loads - fair)
        for thief in map(int, order):
            need = fair[thief] - loads[thief]
            if need <= _TINY:
                break
            if powers[thief] <= 0:
                continue
            # the thief pulls over its *inbound* links (payload travels
            # victim -> thief); the steal request itself is a few control
            # bytes amortized over the exchange period, so the payload
            # transfer is the only delay a stolen task pays
            remaining = {src for (src, dst) in self.links if dst == thief}
            while need > _TINY and remaining:
                reach = np.zeros(n, dtype=bool)
                reach[list(remaining)] = True
                victim = choose_victim(loads, powers, reach)
                if victim < 0:
                    break
                remaining.discard(victim)
                link = self.links[(victim, thief)]
                vt = self.runtimes[victim]
                for task in reversed(vt.queued_tasks()):
                    if need <= _TINY:
                        break
                    if loads[victim] - fair[victim] <= _TINY:
                        break  # robbed down to its own share: stop here
                    if not self._movable(task):
                        continue
                    if task.work > need + _TINY:
                        continue  # a steal never overshoots the deficit
                    delay = link.delay(task.packets)
                    if not admit(loads[victim], powers[victim],
                                 loads[thief], powers[thief], task.work,
                                 delay, margin):
                        self.stats.rejected += 1
                        continue
                    self._move(task, victim, thief, t, delay, stolen=True)
                    loads[victim] -= task.work
                    loads[thief] += task.work
                    need -= task.work

    def _move(self, task, src: int, dst: int, t: float, delay: float, *,
              stolen: bool = False) -> None:
        """Withdraw ``task`` from member ``src`` and send it to ``dst``
        over the WAN, with its still-pending eviction rows riding along."""
        rt = self.runtimes[src]
        leaf = self._owning_leaf(task)
        evictions = tuple(rt.extract_evictions(task.tid))
        src_tr = leaf._tr if leaf is not None else None
        rt.withdraw(task)
        task.migrations += 1
        t_land = t + delay
        self._trace_handoff(task, src, dst, t, t_land, tracer=src_tr,
                            stolen=stolen)
        if self.mode == "lockstep":
            self._deliver(dst, task, t_land, evictions)
        else:
            heapq.heappush(self._heap,
                           (t_land, _RANK_WAN, self._hseq,
                            WanMessage(t_land, src, dst, task, evictions,
                                       stolen)))
            self._hseq += 1
            self._msgs_pending += 1
        self._wan_inflight.append((t_land, dst, task.work))
        self._sent[task.tid] = task.work
        self.stats.migrations += 1
        if stolen:
            self.stats.steals += 1
        self.stats.moved_units += task.work
        self.stats.moved_packets += task.packets

    def _deliver(self, dst: int, task, t_land: float, evictions) -> None:
        """Land a hand-off on member ``dst``: the task enters via the
        member's own placement policy and its eviction rows are re-targeted
        there. Rows the transfer itself overtook (``te <= t_land``) would
        address a task that is nowhere to evict — counted, not lost."""
        kept = tuple(te for te in evictions if te > t_land)
        self.stats.evictions_retargeted += len(kept)
        self.stats.evictions_dropped += len(evictions) - len(kept)
        rt = self.runtimes[dst]
        if isinstance(rt, FederatedRuntime):
            rt.accept_handoff(task, t_land, kept)
        else:
            rt.submit(task, t_land, arrival=False)
            for te in kept:
                rt.schedule_eviction(task.tid, te)

    def accept_handoff(self, task, t: float, evictions=()) -> None:
        """A hand-off from an enclosing federation lands here: pick a
        member by the positional rule at *this* level (the paper's
        recursion applied per federation layer) and deliver."""
        self._scheduled += 1
        n = len(self.runtimes)
        loads = self._member_loads(t)
        powers = np.array([rt.total_power for rt in self.runtimes])
        dst = choose_destination(loads, powers, np.ones(n, dtype=bool),
                                 task.work)
        if dst < 0:
            ratio = np.where(powers > 0,
                             loads / np.maximum(powers, _TINY), np.inf)
            dst = int(np.argmin(ratio)) if np.isfinite(ratio).any() else 0
        rt = self.runtimes[dst]
        if isinstance(rt, FederatedRuntime):
            rt.accept_handoff(task, t, evictions)
        else:
            rt.submit(task, t, arrival=False)
            for te in evictions:
                rt.schedule_eviction(task.tid, te)

    def _trace_handoff(self, task, src: int, dst: int, t: float,
                       t_land: float, *, tracer=None,
                       stolen: bool = False) -> None:
        """Record the causal chain of one WAN hand-off.

        ``trace_id`` is the task id (stable across members); span ids are
        allocated from the member-unique tracers. A first hand-off roots
        the chain with a ``wan_resident`` span covering the task's time at
        the source; every hop adds a ``wan_handoff`` span whose parent is
        the previous link; the destination engine continues the chain on
        landing (``land`` instant) and closes it with the task span. The
        context rides on ``task.trace_ctx`` so relays compose — including
        under async clocks, where the source engine may be far behind the
        landing instant by the time anyone looks."""
        src_tr = tracer if tracer is not None \
            else self.instruments[src].tracer
        dst_tr = self._any_tracer(dst)
        if src_tr is None and dst_tr is None:
            return
        trace_id = task.tid
        parent = task.trace_ctx[1] if task.trace_ctx is not None else -1
        if src_tr is not None:
            if parent < 0:
                parent = src_tr.next_span_id()
                src_tr.span("wan_resident", task.t_arrive, t, tid=task.tid,
                            cat="wan",
                            args={"trace_id": trace_id, "span_id": parent,
                                  "member": src})
            sid = src_tr.next_span_id()
            args = {"trace_id": trace_id, "span_id": sid,
                    "parent_id": parent, "src": src, "dst": dst}
            if stolen:
                args["stolen"] = True
            src_tr.span("wan_handoff", t, t_land, tid=task.tid, cat="wan",
                        args=args)
            parent = sid
        task.trace_ctx = (trace_id, parent)

    def stitched_trace(self) -> dict | None:
        """One clock-aligned Chrome trace over every traced leaf (lane
        pids stride per leaf); ``None`` when nothing traces. Simulated
        clocks are globally shared even under async stepping — events
        carry absolute timestamps — so no offsets apply; WAN hand-off
        spans bridge members whose engines never synchronised."""
        traces, names = [], []
        for name, leaf in self._named_leaves():
            if leaf._tr is not None:
                traces.append(leaf._tr.to_chrome_trace())
                names.append(name)
        if not traces:
            return None
        from ..obs import merge_chrome_traces
        return merge_chrome_traces(traces, names)

    def _sample_wan(self, t: float) -> None:
        """One federation-level telemetry sample at exchange instant
        ``t``: per-member total load plus WAN-in-flight work and
        cumulative exchange counters. Post-exchange, so the stream shows
        the state the next evaluation starts from."""
        self.wan_stream.append({
            "t": t,
            "member_load": [float(rt.total_load(t))
                            for rt in self.runtimes],
            "member_blocked": [rt.census()["blocked"]
                               for rt in self.runtimes],
            "wan_inflight_work": float(sum(
                w for tl, _, w in self._wan_inflight if tl > t)),
            "migrations": self.stats.migrations,
            "moved_units": float(self.stats.moved_units),
            "rejected": self.stats.rejected,
            "steals": self.stats.steals,
        })

    def registry(self):
        """One merged federation-wide ``MetricsRegistry``: every leaf
        collector's families tagged ``member=<path>`` (refreshed first),
        plus federation-level WAN families — in-flight gauges and
        cumulative exchange counters."""
        from ..obs.registry import MetricsRegistry, merge_registries
        regs, names = [], []
        for name, ins in self._named_instruments():
            if ins.collector is not None:
                ins.collector.refresh()
                regs.append(ins.collector.registry)
                names.append(name)
        merged = (merge_registries(regs, "member", names) if regs
                  else MetricsRegistry())
        inflight = [(tl, d, w) for tl, d, w in self._wan_inflight
                    if tl > self._t]
        merged.gauge("fed_wan_inflight_work",
                     "work units crossing WAN links right now").set(
            float(sum(w for _, _, w in inflight)))
        merged.gauge("fed_wan_inflight_tasks",
                     "tasks crossing WAN links right now").set(
            float(len(inflight)))
        merged.counter("fed_wan_migrations_total",
                       "tasks handed off over WAN links").inc(
            float(self.stats.migrations))
        merged.counter("fed_steals_total",
                       "WAN hand-offs initiated by the pull side").inc(
            float(self.stats.steals))
        merged.counter("fed_wan_rejected_total",
                       "hand-offs refused by admission control").inc(
            float(self.stats.rejected))
        merged.counter("fed_evictions_retargeted_total",
                       "eviction rows re-addressed to a task's new "
                       "member").inc(
            float(self.stats.evictions_retargeted))
        merged.counter("fed_evictions_dropped_total",
                       "eviction rows overtaken by a WAN transfer").inc(
            float(self.stats.evictions_dropped))
        return merged

    def scrape(self) -> str:
        """Federation-wide OpenMetrics exposition (see :meth:`registry`)."""
        from ..obs import to_openmetrics
        return to_openmetrics(self.registry())

    def census(self) -> dict:
        """Where every live task is right now, summed over members (and
        nested federations), with WAN messages still on this federation's
        heap counted as pending migrations."""
        agg = {"queued": 0, "running": 0, "in_flight": 0, "blocked": 0,
               "pending_arrivals": 0, "pending_migrations": 0}
        for rt in self.runtimes:
            c = rt.census()
            for key in agg:
                agg[key] += c[key]
        agg["pending_migrations"] += self._msgs_pending
        return agg

    def work_census(self, t: float) -> dict:
        """Federation-wide work-unit audit at instant ``t``: member
        censuses summed, plus WAN transfers still in flight (which sit in
        no member's queues yet). Member-level ``conservation_gap`` is not
        meaningful under WAN exchange — a hand-off moves admitted work
        between members — but the federation-wide identity
        ``admitted == completed + in_flight`` must always hold."""
        agg = {"admitted": 0.0, "completed": 0.0, "wasted": 0.0,
               "in_flight": 0.0}
        for rt in self.runtimes:
            c = rt.work_census(t)
            for key in agg:
                agg[key] += c[key]
        agg["in_flight"] += sum(w for tl, _, w in self._wan_inflight
                                if tl > t)
        agg["conservation_gap"] = abs(
            agg["admitted"] - agg["completed"] - agg["in_flight"])
        return agg

    # -- invariants ----------------------------------------------------------
    def _check_conservation(self, where: str) -> None:
        completed = sum(leaf.metrics.completed
                        for leaf in self._leaf_runtimes())
        c = self.census()
        # in-flight tasks each hold a pending MIGRATION_ARRIVE event (or a
        # WanMessage on a federation heap), so pending_migrations covers
        # local moves, landed hand-offs and hand-offs still in the air
        live = (c["queued"] + c["running"] + c["blocked"]
                + c["pending_arrivals"] + c["pending_migrations"])
        if completed + live != self._scheduled:
            raise RuntimeError(
                f"conservation violated {where}: scheduled="
                f"{self._scheduled} but completed={completed} + live={live}")

    # -- driver --------------------------------------------------------------
    # The federation speaks the same driving verbs as ClusterRuntime and
    # SchedulerService: submit / withdraw / advance / drain. In lockstep
    # mode one epoch — step every member to the boundary, exchange, sample,
    # audit — is the indivisible micro-step; in async mode the heap's next
    # landing or evaluation is.

    def submit(self, task, t: float | None = None, *,
               member: int | None = None) -> None:
        """Admit one live task at time ``t`` (default: now). With
        ``member=None`` the positional rule at this level routes it;
        an explicit index pins it. Counts as a scheduled arrival for the
        conservation audit."""
        t = self._t if t is None else float(t)
        if member is None:
            loads = self._member_loads(t)
            powers = np.array([rt.total_power for rt in self.runtimes])
            member = choose_destination(
                loads, powers, np.ones(len(self.runtimes), dtype=bool),
                task.work)
            if member < 0:
                ratio = np.where(powers > 0,
                                 loads / np.maximum(powers, _TINY), np.inf)
                member = (int(np.argmin(ratio))
                          if np.isfinite(ratio).any() else 0)
        self.runtimes[member].submit(task, t)
        self._scheduled += 1
        if self.mode == "async":
            self._arm_eval(t)

    def withdraw(self, task) -> None:
        """Remove a queued task from whichever member (or nested
        federation) holds it; it stops being this federation's to
        conserve."""
        for rt in self.runtimes:
            if isinstance(rt, FederatedRuntime):
                try:
                    rt.withdraw(task)
                except ValueError:
                    continue
                self._scheduled -= 1
                return
            if rt.tasks.get(task.tid) is task:
                rt.withdraw(task)
                self._scheduled -= 1
                return
        raise ValueError(f"task {task.tid} is not queued in any member")

    def pending_work(self) -> bool:
        """True while any member holds live work or a WAN message is
        still in the air."""
        return bool(self._msgs_pending
                    or any(rt.pending_work() for rt in self.runtimes))

    def requeue_pending(self) -> bool:
        """True while some member can still (re)queue balancer-movable
        work — the async engine stops arming exchange evaluations when
        this goes False, which is what makes the drain tail free."""
        return bool(self._msgs_pending
                    or any(rt.requeue_pending() for rt in self.runtimes))

    def _arm_eval(self, t: float) -> None:
        """Arm the next exchange evaluation on the absolute ``k * period``
        grid strictly after ``t`` — the same grid the lockstep engine
        evaluates on — unless one is already pending or there are no
        links to exchange over."""
        if not self.links or self._evals_pending:
            return
        period = self.federation.exchange_period
        k = math.floor(t / period + 1e-9) + 1
        heapq.heappush(self._heap, (k * period, _RANK_EVAL, self._hseq,
                                    None))
        self._hseq += 1
        self._evals_pending += 1

    def _epoch(self) -> None:
        self._epochs += 1
        self._t += self.federation.exchange_period
        for rt in self.runtimes:
            rt.advance(until=self._t, max_events=2_000_000, strict=True)
        if self.links:
            self._exchange(self._t)
            self.stats.epochs += 1
        if self.wan_stream is not None:
            self._sample_wan(self._t)
        self._check_conservation(f"at epoch t={self._t}")

    def advance(self, until: float | None = None, *,
                max_epochs: int = 200_000, max_events: int | None = None,
                strict: bool = False) -> int:
        """Advance the federation; returns the number of exchange
        evaluations run.

        Lockstep mode steps whole epochs while work is pending and the
        next boundary is <= ``until`` (``None``: until idle). Async mode
        pops the event heap — WAN landings advance *only* the destination
        member to the landing instant; exchange evaluations advance every
        member to the evaluation instant — then runs members to ``until``
        (or dry). ``max_events``/``strict`` exist for driver-interface
        compatibility with ``ClusterRuntime.advance`` (members always run
        under their own event budget)."""
        if self.mode == "lockstep":
            period = self.federation.exchange_period
            n = 0
            while any(rt.pending_work() for rt in self.runtimes):
                if until is not None and self._t + period > until:
                    break
                n += 1
                if n > max_epochs:
                    raise RuntimeError(
                        f"epoch budget exhausted ({max_epochs})")
                self._epoch()
            return n
        n = 0
        while self._heap and (until is None
                              or self._heap[0][0] <= until):
            t, rank, _, msg = heapq.heappop(self._heap)
            self._t = max(self._t, t)
            if msg is not None:
                self._msgs_pending -= 1
                rt = self.runtimes[msg.dst]
                rt.advance(until=t, max_events=2_000_000, strict=True)
                self._deliver(msg.dst, msg.task, t, msg.evictions)
                # landed work must be seen by some future evaluation
                self._arm_eval(t)
                continue
            self._evals_pending -= 1
            n += 1
            if n > max_epochs:
                raise RuntimeError(f"epoch budget exhausted ({max_epochs})")
            self._epochs += 1
            for rt in self.runtimes:
                rt.advance(until=t, max_events=2_000_000, strict=True)
            self._exchange(t)
            self.stats.epochs += 1
            if self.wan_stream is not None:
                self._sample_wan(t)
            self._check_conservation(f"at exchange t={t}")
            if self.requeue_pending():
                self._arm_eval(t)
        if until is None:
            for rt in self.runtimes:
                rt.advance()
            self._t = max(
                [self._t] + [rt._t if isinstance(rt, FederatedRuntime)
                             else rt._now for rt in self.runtimes])
        else:
            for rt in self.runtimes:
                rt.advance(until=until, max_events=2_000_000, strict=True)
            self._t = max(self._t, until)
        return n

    def drain(self, *, max_epochs: int = 200_000) -> FederationReport:
        """Run every member dry, then audit and report."""
        self.advance(max_epochs=max_epochs)
        self._finalize()
        members = [rt.metrics for rt in self.runtimes]
        return FederationReport(aggregate=aggregate_metrics(members),
                                members=members, wan=self.stats,
                                epochs=self._epochs)

    def run(self, *, max_epochs: int = 200_000) -> FederationReport:
        """Convenience over the session verbs: ``drain()``."""
        return self.drain(max_epochs=max_epochs)

    def _finalize(self) -> None:
        completed = sum(leaf.metrics.completed
                        for leaf in self._leaf_runtimes())
        if completed != self._scheduled:
            raise RuntimeError(
                f"run ended with {completed}/{self._scheduled} tasks "
                f"completed")
        sent = sum(self._sent.values())
        landed = sum(task.work
                     for leaf in self._leaf_runtimes()
                     for task in leaf.tasks.values()
                     if task.tid in self._sent)
        if abs(landed - sent) > 1e-6 * max(sent, 1.0):
            raise RuntimeError(
                f"WAN work not conserved: sent {sent} units, "
                f"{landed} landed")
