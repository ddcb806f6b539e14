"""Live cluster probes: sampled time-series from a running cluster.

A :class:`ProbeSeries` is driven by the event engine on a fixed cadence
(``every`` simulated time units, via a self-re-arming PROBE_SAMPLE event)
and records, per sample:

- per-node load (outstanding work units) and occupancy (load / power,
  i.e. expected seconds until the node drains — Dask's "occupancy");
- per-node queue depth (queued + running task count);
- per-priority-tier queued work;
- hyper-grid imbalance at every recursion level (level 0 = across the
  leading-dimension slices, level d-1 = per-node), the signal the
  critical-point monitor watches.

The batched backend produces the same queue/imbalance series as per-slot
engine outputs (see ``runtime.vector_backend``); this module only holds
the event-engine sampler and the shared level-wise imbalance helper.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.hypergrid import HyperGrid
from ..core.trigger import imbalance

__all__ = ["ProbeSeries", "imbalance_by_level"]


def imbalance_by_level(loads: np.ndarray, grid: HyperGrid) -> list[float]:
    """Imbalance of ``loads`` at each hyper-grid recursion level.

    Level ``k`` aggregates loads and powers over the trailing
    ``ndim - 1 - k`` dimensions, i.e. measures how unevenly work is spread
    across the sub-hyper-grids ``G^{d-k}`` of paper eq. 1. The last level
    is the plain per-node imbalance that feeds the crossover trigger.
    """
    loads = np.asarray(loads, dtype=np.float64).reshape(grid.dims)
    powers = grid.powers.reshape(grid.dims)
    out = []
    for level in range(grid.ndim):
        axes = tuple(range(level + 1, grid.ndim))
        lv_loads = loads.sum(axis=axes) if axes else loads
        lv_powers = powers.sum(axis=axes) if axes else powers
        out.append(float(imbalance(lv_loads.ravel(), lv_powers.ravel())))
    return out


def _imbalance_by_level_batch(loads: np.ndarray,
                              grid: HyperGrid) -> list[list[float]]:
    """:func:`imbalance_by_level` for a whole ``(samples, nodes)`` batch
    sharing one grid; one numpy reduction per level instead of one Python
    call per sample. Matches the scalar helper's semantics exactly: work
    on a zero-power (failed/virtual) slot is stranded -> ``inf``; an empty
    or powerless level reads 0."""
    s = loads.shape[0]
    shaped = loads.reshape((s,) + grid.dims)
    powers = grid.powers.reshape(grid.dims)
    out = np.zeros((s, grid.ndim))
    for level in range(grid.ndim):
        axes = tuple(range(level + 1, grid.ndim))
        lv_powers = (powers.sum(axis=axes) if axes else powers).ravel()
        lv_loads = (shaped.sum(axis=tuple(a + 1 for a in axes)) if axes
                    else shaped).reshape(s, -1)
        active = lv_powers > 0
        pi = float(lv_powers[active].sum())
        w = lv_loads.sum(axis=1)
        col = out[:, level]
        if pi > 0 and active.any():
            ok = w > 0
            if ok.any():
                t_now = (lv_loads[:, active] / lv_powers[active]).max(axis=1)
                col[ok] = t_now[ok] / (w[ok] / pi) - 1.0
        if not active.all():
            col[lv_loads[:, ~active].sum(axis=1) > 0] = np.inf
    return out.tolist()


class ProbeSeries:
    """Append-only sampled time-series with a fixed cadence.

    ``record`` is the hot path (it runs inside the event loop on every
    cadence tick), so it only appends raw samples plus the sample's grid
    reference (grids are immutable and replaced wholesale on churn, so a
    reference pins powers/dims as they were at sample time). The derived
    series — occupancy (load / power) and per-recursion-level imbalance —
    are computed lazily on first access of :attr:`occupancy` /
    :attr:`imbalance` or at :meth:`to_dict`.
    """

    def __init__(self, every: float):
        if not (every > 0 and math.isfinite(every)):
            raise ValueError(f"probe cadence must be positive, got {every}")
        self.every = float(every)
        self.t: list[float] = []
        self.node_load: list[list[float]] = []
        self.queue_depth: list[list[int]] = []
        self.tier_work: dict[int, list[float]] = {}
        self.in_flight: list[int] = []
        self.queued_tasks: list[int] = []
        # DAG release-frontier size: arrived tasks still gated on parents
        # (always 0 for independent-task workloads and the batched backend)
        self.blocked_tasks: list[int] = []
        self._grids: list[HyperGrid] = []
        self._derived: tuple[int, list, list] | None = None  # cache

    def __len__(self) -> int:
        return len(self.t)

    def observe(self, runtime, t: float) -> None:
        """Sample one snapshot from a ``ClusterRuntime``-compatible object
        (anything exposing ``probe_snapshot(t)`` and ``grid``)."""
        snap = runtime.probe_snapshot(t)
        self.record(t, grid=runtime.grid, **snap)

    def record(self, t: float, *, grid: HyperGrid, node_load, queue_depth,
               tier_work: dict, in_flight: int, queued_tasks: int,
               blocked_tasks: int = 0) -> None:
        self.t.append(float(t))
        self.blocked_tasks.append(int(blocked_tasks))
        # a list (the runtime fast path) is copied element-wise; arrays and
        # other sequences go through numpy. Either way the stored sample is
        # a fresh row of python floats.
        self.node_load.append(
            [float(x) for x in node_load] if type(node_load) is list
            else np.asarray(node_load, dtype=np.float64).tolist())
        self.queue_depth.append(list(queue_depth))
        self.in_flight.append(int(in_flight))
        self.queued_tasks.append(int(queued_tasks))
        self._grids.append(grid)
        # tiers appear lazily; backfill new tiers with zeros so every
        # series stays sample-aligned
        n_prev = len(self.t) - 1
        for tier in tier_work:
            if tier not in self.tier_work:
                self.tier_work[int(tier)] = [0.0] * n_prev
        for tier, series in self.tier_work.items():
            series.append(float(tier_work.get(tier, 0.0)))

    def _derive(self) -> tuple[list, list]:
        """(occupancy rows, imbalance-by-level rows), cached per length.

        Vectorized across runs of consecutive samples sharing one grid
        object (grids are immutable and replaced wholesale on churn, so
        identity runs are long) — the per-sample scalar path costs ~75us
        a sample, which would dominate export time for long series.
        """
        if self._derived is not None and self._derived[0] == len(self.t):
            return self._derived[1], self._derived[2]
        occ_rows, imb_rows = [], []
        n, i = len(self.t), 0
        while i < n:
            grid = self._grids[i]
            j = i + 1
            while j < n and self._grids[j] is grid:
                j += 1
            loads = np.asarray(self.node_load[i:j], dtype=np.float64)
            powers = grid.powers
            occ = np.divide(loads, powers[None, :],
                            out=np.zeros_like(loads),
                            where=powers[None, :] > 0)
            occ_rows.extend(occ.tolist())
            imb_rows.extend(_imbalance_by_level_batch(loads, grid))
            i = j
        self._derived = (len(self.t), occ_rows, imb_rows)
        return occ_rows, imb_rows

    @property
    def occupancy(self) -> list[list[float]]:
        return self._derive()[0]

    @property
    def imbalance(self) -> list[list[float]]:
        """Per-sample imbalance at each recursion level."""
        return self._derive()[1]

    def to_dict(self) -> dict:
        """JSON-safe export: non-finite imbalance (work stranded on failed
        nodes) becomes None so ``json.dump(..., allow_nan=False)`` works."""
        occ_rows, imb_rows = self._derive()

        def _clean(levels):
            return [x if math.isfinite(x) else None for x in levels]
        return {
            "every": self.every,
            "t": list(self.t),
            "node_load": [list(row) for row in self.node_load],
            "occupancy": [list(row) for row in occ_rows],
            "queue_depth": [list(row) for row in self.queue_depth],
            "tier_work": {str(k): list(v) for k, v in self.tier_work.items()},
            "imbalance_by_level": [_clean(row) for row in imb_rows],
            "in_flight": list(self.in_flight),
            "queued_tasks": list(self.queued_tasks),
            "blocked_tasks": list(self.blocked_tasks),
        }
