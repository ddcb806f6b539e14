"""Google cluster-data machine_events parser: capacity churn as a fault
schedule.

Column -> field semantics (machine_events table, one row per event)::

    col  name                      used as
    ---  ------------------------  -------------------------------------
      0  timestamp (microseconds)  fault-schedule event time
      1  machine ID                node identity (dense-mapped, sorted)
      2  event type                0 ADD / 1 REMOVE / 2 UPDATE
      4  CPU capacity (normalized) relative node power

The table maps onto the event engine's existing fault vocabulary:

* **REMOVE** of an up machine -> a node *failure* (queued + running work
  re-placed, the running task restarting from scratch);
* **ADD** of a previously removed machine -> a node *join*;
* **ADD** of a machine first seen mid-trace -> a failure at t=0 plus a
  join at the ADD time (the node simply does not exist before it);
* **UPDATE** (capacity change) of an up machine -> a node *resize*: the
  node's power becomes ``base_power x (capacity / first-seen capacity)``,
  applied in place — a running task keeps its banked progress and finishes
  at the new rate. An UPDATE to zero capacity is a REMOVE.

Machine IDs are dense-mapped to node indices in sorted-ID order (stable
under the public trace's shard interleaving); the consuming cluster must
declare at least ``n_machines`` nodes. Timestamps share the task_events
clock: pass the same ``time_scale``, and ``t_zero`` (raw timestamp of the
trace's first task SUBMIT) when the excerpt does not start at zero.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .io import read_numeric_csv

__all__ = ["MachineSchedule", "load_google_machine_events",
           "MACHINE_EVENT_TYPES"]

MACHINE_EVENT_TYPES = {"ADD": 0, "REMOVE": 1, "UPDATE": 2}

_USECOLS = (0, 1, 2, 4)
_T, _MID, _EV, _CPU = range(len(_USECOLS))


@dataclass(frozen=True)
class MachineSchedule:
    """A trace's capacity churn, in the event engine's fault vocabulary.

    ``failures``/``joins`` are ``(time, node)`` pairs; ``resizes`` are
    ``(time, node, fraction)`` triples where ``fraction`` scales the node's
    *base* power (1.0 = nominal). Node indices are dense machine positions
    ``0..n_machines-1``.
    """

    n_machines: int = 0
    machine_ids: tuple[int, ...] = ()
    failures: tuple[tuple[float, int], ...] = ()
    joins: tuple[tuple[float, int], ...] = ()
    resizes: tuple[tuple[float, int, float], ...] = ()

    @property
    def empty(self) -> bool:
        return not (self.failures or self.joins or self.resizes)

    def events(self) -> int:
        return len(self.failures) + len(self.joins) + len(self.resizes)


def load_google_machine_events(path, *, time_scale: float = 1e-6,
                               t_zero: float = 0.0,
                               chunk_bytes: int = 1 << 24
                               ) -> MachineSchedule:
    """Parse a machine_events file (plain or gzipped CSV) into a
    :class:`MachineSchedule`; see the module docstring for the mapping."""
    rows = read_numeric_csv(path, usecols=_USECOLS, chunk_bytes=chunk_bytes)
    if rows.shape[0] == 0:
        return MachineSchedule()
    ts = (rows[:, _T] - float(t_zero)) * float(time_scale)
    mids = rows[:, _MID]
    if not np.isfinite(mids).all():
        raise ValueError(f"machine_events {path!r}: non-numeric machine ID")
    mids = mids.astype(np.int64)
    evs = rows[:, _EV].astype(np.int64)
    bad = set(np.unique(evs)) - set(MACHINE_EVENT_TYPES.values())
    if bad:
        raise ValueError(f"machine_events {path!r}: unknown event type(s) "
                         f"{sorted(bad)}")
    cpus = rows[:, _CPU]

    uniq = np.unique(mids)  # sorted: the stable machine -> node mapping
    node_of = {int(mid): i for i, mid in enumerate(uniq.tolist())}
    # same-timestamp ties fold REMOVE -> UPDATE -> ADD, so a reboot
    # recorded at one stamp blips (fail + rejoin) instead of dying — the
    # event engine's own NODE_FAIL-before-NODE_JOIN convention
    tie = np.array([2, 0, 1], dtype=np.int8)[evs]  # ADD=2, REMOVE=0, UPD=1
    order = np.lexsort((tie, mids, ts))

    failures: list[tuple[float, int]] = []
    joins: list[tuple[float, int]] = []
    resizes: list[tuple[float, int, float]] = []
    state = _MachineState()
    for r in map(int, order):
        t = max(float(ts[r]), 0.0)
        node = node_of[int(mids[r])]
        cap = float(cpus[r]) if np.isfinite(cpus[r]) else np.nan
        kind = int(evs[r])
        if kind == MACHINE_EVENT_TYPES["ADD"]:
            state.add(node, t, cap, failures, joins, resizes)
        elif kind == MACHINE_EVENT_TYPES["REMOVE"]:
            state.remove(node, t, failures)
        else:  # UPDATE
            state.update(node, t, cap, failures, joins, resizes)
    return MachineSchedule(
        n_machines=int(uniq.shape[0]),
        machine_ids=tuple(int(m) for m in uniq.tolist()),
        failures=tuple(failures), joins=tuple(joins),
        resizes=tuple(resizes))


@dataclass
class _MachineState:
    """Per-machine bookkeeping while folding time-sorted rows.

    ``applied`` is the fraction the *runtime* currently has for the node
    (last emitted resize, 1.0 nominal); ``desired`` the latest capacity
    seen in the trace. Capacity changes observed while a machine is down
    only update ``desired`` — the reconciling resize is emitted when the
    machine rejoins. ``removed`` separates the two ways of being down:
    a REMOVEd machine needs an ADD to come back, while one downed by a
    zero-capacity UPDATE recovers as soon as an UPDATE restores capacity.
    """

    up: dict[int, bool] = field(default_factory=dict)
    removed: set[int] = field(default_factory=set)
    cap_ref: dict[int, float] = field(default_factory=dict)
    applied: dict[int, float] = field(default_factory=dict)
    desired: dict[int, float] = field(default_factory=dict)

    def _fraction(self, node: int, cap: float) -> float:
        """Capacity as a fraction of the machine's first-seen capacity."""
        if not np.isfinite(cap) or cap < 0:
            return self.desired.get(node, 1.0)  # blank capacity: unchanged
        ref = self.cap_ref.setdefault(node, cap if cap > 0 else 1.0)
        return cap / ref if ref > 0 else 0.0

    def _reconcile(self, node, t, failures, resizes):
        """Emit whatever brings the runtime's power for an up node to the
        desired fraction (a zero fraction is a removal in disguise)."""
        want = self.desired.get(node, 1.0)
        if want <= 0:
            if self.up.get(node, False):
                failures.append((t, node))
                self.up[node] = False
        elif abs(want - self.applied.get(node, 1.0)) > 1e-12:
            resizes.append((t, node, want))
            self.applied[node] = want

    def add(self, node, t, cap, failures, joins, resizes):
        self.desired[node] = self._fraction(node, cap)
        self.removed.discard(node)
        if node not in self.up:  # first sighting
            self.up[node] = t <= 0  # census machine; mid-trace birth is
            if t > 0:               # absent until this ADD
                failures.append((0.0, node))
        if not self.up[node]:
            if self.desired[node] <= 0:
                return  # an ADD at zero capacity never raises the node
            joins.append((t, node))
            self.up[node] = True
        # a duplicate ADD of an up machine acts as a capacity UPDATE
        self._reconcile(node, t, failures, resizes)

    def remove(self, node, t, failures):
        if node not in self.up:
            # REMOVE as a machine's first row (an excerpt cut mid-trace):
            # it existed — and was up — before the cut
            self.up[node] = True
        if self.up[node]:
            failures.append((t, node))
        self.up[node] = False
        self.removed.add(node)

    def update(self, node, t, cap, failures, joins, resizes):
        self.desired[node] = self._fraction(node, cap)
        if node not in self.up:  # UPDATE before any ADD: initial census
            self.up[node] = True
        elif not self.up[node] and node not in self.removed \
                and self.desired[node] > 0:
            # downed by a zero-capacity UPDATE, not a REMOVE: a capacity
            # recovery brings the machine straight back up
            joins.append((t, node))
            self.up[node] = True
        if self.up[node]:
            self._reconcile(node, t, failures, resizes)
