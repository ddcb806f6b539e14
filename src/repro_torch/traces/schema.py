"""The normalized trace schema: priorities and placement constraints.

Every trace format (Google cluster-data task events, Azure Packing Trace,
the repo's own normalized CSV) parses into one :class:`TraceSchema` — a
:class:`repro_torch.runtime.workload.Workload` extended with two new per-task
axes the paper's synthetic workloads do not have:

* ``priority`` — int tiers, **tier 0 = most important**. Parsers remap
  native priority scales (Google: bigger number = more important; Azure:
  1 = high, 0 = spot) onto dense ascending tiers so downstream code never
  needs format knowledge. Tiers order admission within an arrival batch
  and per-node queue service (nonpreemptive — a started task finishes).
* ``constraints`` — sparse node-attribute predicates, e.g.
  ``machine_class >= 2``. A task may carry any number of predicates; a
  node is *feasible* for a task iff it satisfies all of them. Constraints
  reference cluster attributes by name and are resolved against the
  cluster's attribute table (``lab.ClusterSpec(attrs=...)``) at run time.

Feasibility evaluation is vectorized: predicates are grouped by their
``(attr, op, value)`` signature, each signature is evaluated once against
all nodes, and the per-task AND is a grouped scatter — million-task masks
cost milliseconds, not minutes.

Traces additionally carry *churn*: sparse :class:`Evictions` rows replay a
real cluster's preemptions as exogenous requeue events, and the per-task
``ends_evicted`` flag records tasks whose trace life ended in an
EVICT/KILL/FAIL rather than a FINISH, so replays can count them apart from
genuine completions.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from ..graphs import DagSpec
# one class for the engine's raises and the lab's catches: the event engine
# defines it, this schema re-exports it
from ..runtime.runtime import InfeasibleTaskError
from ..runtime.workload import Workload

__all__ = [
    "OPS",
    "OP_NAMES",
    "Constraints",
    "Evictions",
    "TraceSchema",
    "InfeasibleTaskError",
    "dense_tiers",
    "hash_attr_value",
]

# predicate operator codes (Google task_constraints uses 0-3; <=/>= are
# the natural spellings for threshold attributes like machine class)
OPS = {"==": 0, "!=": 1, "<": 2, ">": 3, "<=": 4, ">=": 5}
OP_NAMES = {v: k for k, v in OPS.items()}

_OP_FNS = {
    0: np.equal,
    1: np.not_equal,
    2: np.less,
    3: np.greater,
    4: np.less_equal,
    5: np.greater_equal,
}


def hash_attr_value(value) -> float:
    """Stable numeric code for an attribute value of any type.

    Numeric values (and numeric-looking strings) pass through as plain
    floats. Opaque strings — the hashed categorical values in the public
    Google trace, e.g. machine platform ids — map to the first 48 bits of
    their SHA-256, so the code is deterministic across runs/processes
    (unlike ``hash()``) and exactly representable in the float64
    ``Constraints.value`` column (48 < 53 mantissa bits: ``==``/``!=``
    predicates compare exactly). Ordering of hashed codes is meaningless;
    callers must restrict hashed values to equality operators.
    """
    try:
        return float(value)
    except (TypeError, ValueError):
        pass
    digest = hashlib.sha256(str(value).encode("utf-8")).digest()
    return float(int.from_bytes(digest[:6], "big"))


def _gather_rows(src_task: np.ndarray, tasks: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Resampling gather shared by the sparse per-task axes: for each new
    task ``i`` (inheriting source task ``tasks[i]``), the source row
    indices carrying that task's entries (duplicates copy their rows).
    Returns ``(new_task, rows)`` — empty when nothing matches."""
    order = np.argsort(src_task, kind="stable")
    srt = src_task[order]
    start = np.searchsorted(srt, tasks, side="left")
    stop = np.searchsorted(srt, tasks, side="right")
    cnt = stop - start
    total = int(cnt.sum())
    if total == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty
    new_task = np.repeat(np.arange(tasks.shape[0], dtype=np.int64), cnt)
    base = np.repeat(start, cnt)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return new_task, order[base + offs]


@dataclass(frozen=True)
class Constraints:
    """Sparse per-task predicates: row ``j`` says task ``task[j]`` requires
    ``attrs[attr_names[attr[j]]] <op[j]> value[j]`` on its node.

    ``attr_names`` holds the attribute vocabulary this constraint set
    references; ``attr`` indexes into it. A task absent from ``task`` is
    unconstrained (feasible everywhere).
    """

    attr_names: tuple[str, ...] = ()
    task: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    attr: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    op: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    value: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))

    def __post_init__(self):
        object.__setattr__(self, "attr_names",
                           tuple(str(a) for a in self.attr_names))
        object.__setattr__(self, "task",
                           np.asarray(self.task, dtype=np.int64))
        object.__setattr__(self, "attr",
                           np.asarray(self.attr, dtype=np.int32))
        object.__setattr__(self, "op", np.asarray(self.op, dtype=np.int8))
        object.__setattr__(self, "value",
                           np.asarray(self.value, dtype=np.float64))
        k = self.task.shape[0]
        for name in ("attr", "op", "value"):
            if getattr(self, name).shape[0] != k:
                raise ValueError("constraint columns must share one length")
        if k:
            if self.attr.min() < 0 or self.attr.max() >= len(self.attr_names):
                raise ValueError("constraint attr index out of range")
            bad = set(np.unique(self.op)) - set(_OP_FNS)
            if bad:
                raise ValueError(f"unknown constraint op codes {sorted(bad)}")

    @property
    def k(self) -> int:
        return int(self.task.shape[0])

    @property
    def empty(self) -> bool:
        return self.k == 0

    def describe_task(self, tid: int) -> str:
        """Human-readable predicate list for one task (diagnostics)."""
        rows = np.flatnonzero(self.task == tid)
        if rows.size == 0:
            return "(unconstrained)"
        return " AND ".join(
            f"{self.attr_names[self.attr[j]]} "
            f"{OP_NAMES[int(self.op[j])]} {self.value[j]:g}"
            for j in rows)

    def select(self, tasks: np.ndarray) -> "Constraints":
        """Constraint rows for a resampled task list: new task ``i`` inherits
        the rows of source task ``tasks[i]`` (duplicates copy their rows)."""
        tasks = np.asarray(tasks, dtype=np.int64)
        if self.empty:
            return Constraints(self.attr_names)
        new_task, rows = _gather_rows(self.task, tasks)
        if rows.size == 0:
            return Constraints(self.attr_names)
        return Constraints(self.attr_names, new_task, self.attr[rows],
                           self.op[rows], self.value[rows])

    def node_mask(self, m: int, attr_names, attr_matrix) -> np.ndarray:
        """``(m, n)`` feasibility: node ``j`` satisfies all of task ``i``'s
        predicates. ``attr_matrix`` is the cluster's ``(n, A)`` attribute
        table with columns named by ``attr_names``. Referencing an
        attribute the cluster does not declare is a loud error — silently
        treating it as unsatisfiable would look like a scheduling bug."""
        attr_matrix = np.asarray(attr_matrix, dtype=np.float64)
        n = attr_matrix.shape[0]
        mask = np.ones((m, n), dtype=bool)
        if self.empty:
            return mask
        col = {name: j for j, name in enumerate(attr_names)}
        missing = [a for a in self.attr_names if a not in col]
        if missing:
            raise InfeasibleTaskError(
                f"trace constraints reference cluster attributes "
                f"{sorted(missing)} but the cluster declares "
                f"{sorted(col) or 'none'}; add them via "
                f"ClusterSpec(attrs={{...}})")
        # evaluate each distinct (attr, op, value) signature once over all
        # nodes, then AND it into every task carrying that signature
        sig = np.stack([self.attr.astype(np.int64),
                        self.op.astype(np.int64),
                        self.value.view(np.int64)], axis=1)
        uniq, inv = np.unique(sig, axis=0, return_inverse=True)
        for u in range(uniq.shape[0]):
            a = int(uniq[u, 0])
            o = int(uniq[u, 1])
            v = float(np.asarray(uniq[u, 2], dtype=np.int64)
                      .view(np.float64))
            sat = _OP_FNS[o](attr_matrix[:, col[self.attr_names[a]]], v)
            rows = inv == u
            np.logical_and.at(mask, self.task[rows], sat[None, :])
        return mask


@dataclass(frozen=True)
class Evictions:
    """Sparse exogenous eviction events: row ``j`` says task ``task[j]`` is
    preempted at trace-relative time ``time[j]`` (same clock as
    ``t_arrive``). A task may carry any number of rows; a task absent from
    ``task`` is never evicted.

    The event engine replays each row by pulling the task off its machine,
    discarding the interrupted attempt's progress (wasted work — a
    nonpreemptive scheduler cannot checkpoint mid-task), and requeueing the
    task through the normal tier-ordered admission path. Rows whose task is
    already finished at fire time are no-ops — under a better policy the
    replay simply outruns the trace's churn.
    """

    task: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    time: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))

    def __post_init__(self):
        object.__setattr__(self, "task",
                           np.asarray(self.task, dtype=np.int64))
        object.__setattr__(self, "time",
                           np.asarray(self.time, dtype=np.float64))
        if self.time.shape[0] != self.task.shape[0]:
            raise ValueError("eviction columns must share one length")
        if self.task.shape[0] and not np.isfinite(self.time).all():
            raise ValueError("eviction times must be finite")

    @property
    def k(self) -> int:
        return int(self.task.shape[0])

    @property
    def empty(self) -> bool:
        return self.k == 0

    def select(self, tasks: np.ndarray) -> "Evictions":
        """Eviction rows for a resampled task list: new task ``i`` inherits
        the rows of source task ``tasks[i]`` (duplicates copy their rows).
        Times are copied verbatim; shift them afterwards if the resample
        moved the task's arrival (see :func:`repro_torch.traces.trace_scale`)."""
        tasks = np.asarray(tasks, dtype=np.int64)
        if self.empty:
            return Evictions()
        new_task, rows = _gather_rows(self.task, tasks)
        if rows.size == 0:
            return Evictions()
        return Evictions(new_task, self.time[rows])

    def shifted(self, delta: np.ndarray) -> "Evictions":
        """Times moved by a per-task offset (``delta[task[j]]``) — how a
        resampled task drags its eviction schedule along with its arrival."""
        if self.empty:
            return self
        delta = np.asarray(delta, dtype=np.float64)
        return Evictions(self.task, self.time + delta[self.task])


def dense_tiers(raw: np.ndarray, *, higher_is_more_important: bool
                ) -> np.ndarray:
    """Remap a native priority column onto dense tiers 0..T-1 with tier 0
    the most important, preserving the native ordering."""
    raw = np.asarray(raw)
    values = np.unique(raw)  # ascending
    if higher_is_more_important:
        values = values[::-1]
    rank = {v: i for i, v in enumerate(values.tolist())}
    return np.array([rank[v] for v in raw.tolist()], dtype=np.int32)


@dataclass(frozen=True)
class TraceSchema(Workload):
    """A :class:`Workload` with priority tiers and placement constraints.

    Plain-``Workload`` consumers (the batched fluid backend, ``to_slots``)
    see the base fields unchanged; priority/constraint awareness is opt-in
    via ``isinstance`` or the ``constrained``/``n_tiers`` properties.
    """

    priority: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    constraints: Constraints = field(default_factory=Constraints)
    # exogenous preemption replay: (task, time) requeue events, plus a
    # per-task flag for tasks whose *trace* life ended in an eviction/kill
    # rather than a FINISH (the end-mode throughput-inflation fix)
    evictions: Evictions = field(default_factory=Evictions)
    ends_evicted: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.bool_))
    # task-dependency DAG: parent edges + per-task output bytes; an empty
    # DagSpec means a bag of independent tasks
    dag: DagSpec = field(default_factory=DagSpec)
    # the *raw* timestamp (source units, pre-time_scale) that t_arrive=0
    # corresponds to — what companion files on the same raw clock
    # (machine_events) must be re-zeroed against. 0.0 for formats whose
    # clock already starts at zero (normalized CSV, synthetic).
    t_zero_raw: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        pr = np.asarray(self.priority, dtype=np.int32)
        if pr.shape[0] == 0 and self.m:
            pr = np.zeros(self.m, dtype=np.int32)
        if pr.shape[0] != self.m:
            raise ValueError(
                f"priority has {pr.shape[0]} entries for {self.m} tasks")
        if pr.size and pr.min() < 0:
            raise ValueError("priority tiers must be >= 0")
        object.__setattr__(self, "priority", pr)
        c = self.constraints
        if not isinstance(c, Constraints):
            raise TypeError("constraints must be a Constraints instance")
        if not c.empty and (c.task.min() < 0 or c.task.max() >= self.m):
            raise ValueError("constraint rows reference tasks outside the "
                             f"trace (m={self.m})")
        ev = self.evictions
        if not isinstance(ev, Evictions):
            raise TypeError("evictions must be an Evictions instance")
        if not ev.empty and (ev.task.min() < 0 or ev.task.max() >= self.m):
            raise ValueError("eviction rows reference tasks outside the "
                             f"trace (m={self.m})")
        ee = np.asarray(self.ends_evicted, dtype=np.bool_)
        if ee.shape[0] == 0 and self.m:
            ee = np.zeros(self.m, dtype=np.bool_)
        if ee.shape[0] != self.m:
            raise ValueError(
                f"ends_evicted has {ee.shape[0]} entries for {self.m} tasks")
        object.__setattr__(self, "ends_evicted", ee)
        dag = self.dag
        if not isinstance(dag, DagSpec):
            raise TypeError("dag must be a DagSpec instance")
        if not dag.empty and dag.m != self.m:
            raise ValueError(
                f"dag declares {dag.m} tasks but the trace has {self.m}")
        object.__setattr__(self, "t_zero_raw", float(self.t_zero_raw))

    @property
    def n_tiers(self) -> int:
        return int(self.priority.max()) + 1 if self.m else 0

    @property
    def constrained(self) -> bool:
        return not self.constraints.empty

    @property
    def preempted(self) -> bool:
        """True when the trace carries requeue (eviction) events."""
        return not self.evictions.empty

    @property
    def has_dag(self) -> bool:
        """True when the trace carries task-dependency edges."""
        return not self.dag.empty

    def clipped(self, horizon: float) -> "TraceSchema":
        """Tasks arriving before ``horizon`` (constraint and eviction rows
        re-indexed; a kept task keeps its whole eviction schedule, even
        rows firing past the horizon — the *run* horizon decides what
        actually executes)."""
        keep = self.t_arrive < horizon
        idx = np.flatnonzero(keep)
        return TraceSchema(
            t_arrive=self.t_arrive[keep], works=self.works[keep],
            packets=self.packets[keep], priority=self.priority[keep],
            constraints=self.constraints.select(idx),
            evictions=self.evictions.select(idx),
            ends_evicted=self.ends_evicted[keep],
            dag=self.dag.select(idx) if not self.dag.empty else DagSpec(),
            t_zero_raw=self.t_zero_raw)

    def feasibility(self, attr_names, attr_matrix) -> np.ndarray:
        """Per-task node feasibility ``(m, n)`` against a cluster attribute
        table; raises :class:`InfeasibleTaskError` naming the first task no
        node can satisfy (the diagnostic contract: never a silent hang)."""
        mask = self.constraints.node_mask(self.m, attr_names, attr_matrix)
        dead = np.flatnonzero(~mask.any(axis=1))
        if dead.size:
            t = int(dead[0])
            raise InfeasibleTaskError(
                f"{dead.size} task(s) have constraints no node satisfies; "
                f"first: task {t} requires "
                f"{self.constraints.describe_task(t)} but no node's "
                f"attributes match")
        return mask

    def tier_counts(self) -> dict[int, int]:
        tiers, counts = np.unique(self.priority, return_counts=True)
        return {int(t): int(c) for t, c in zip(tiers, counts)}
