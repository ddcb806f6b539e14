"""Shared metrics accumulator for runtime policies.

Every policy run — event engine or vectorized backend — reports through the
same quantities so policy comparisons are apples-to-apples: makespan, mean and
P99 response time (completion minus arrival), migration count/volume, trigger
statistics, and failure restarts.

P99 is nearest-rank (not interpolated) so the scalar engine, the vectorized
backend and numpy/JAX agree bit-for-bit on small samples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Metrics", "nearest_rank"]


def nearest_rank(values: np.ndarray, pct: float) -> float:
    """Nearest-rank percentile: the ceil(pct/100 * n)-th smallest value."""
    values = np.sort(np.asarray(values, dtype=np.float64))
    n = values.shape[0]
    if n == 0:
        return float("nan")
    k = min(max(int(math.ceil(pct / 100.0 * n)), 1), n)
    return float(values[k - 1])


@dataclass
class Metrics:
    """Accumulator owned by one runtime run."""

    arrived: int = 0
    completed: int = 0
    migrations: int = 0
    moved_packets: float = 0.0
    moved_units: float = 0.0
    trigger_evals: int = 0
    trigger_fires: int = 0
    restarts: int = 0
    failures: int = 0
    joins: int = 0
    # capacity churn + preemption replay: resize events applied,
    # evictions observed (requeues, plus end-mode eviction-truncated
    # "completions" — which would otherwise silently inflate throughput)
    resizes: int = 0
    evictions: int = 0
    # work-unit odometers: admitted counts each task's demand once at
    # arrival; completed_work counts it once at completion; wasted_work is
    # service burned on attempts that lost their progress to an eviction
    # or a failure restart. Conservation: admitted == completed_work +
    # outstanding (ClusterRuntime.work_census), and every delivered
    # service unit is useful, wasted, or in-progress.
    admitted_work: float = 0.0
    completed_work: float = 0.0
    wasted_work: float = 0.0
    # DAG workloads: locality hits/misses count service attempts of
    # tasks with DAG inputs — a hit starts on the node holding the largest
    # parent output; dag_bytes_moved totals remote parent-output bytes
    # fetched; cp_lower_bound is the workload's arrival-aware critical-path
    # bound (the earliest any schedule could finish — cp_stretch normalizes
    # makespan against it, Dutot et al.)
    locality_hits: int = 0
    locality_misses: int = 0
    dag_bytes_moved: float = 0.0
    cp_lower_bound: float = 0.0
    makespan: float = 0.0
    responses: list[float] = field(default_factory=list)
    waits: list[float] = field(default_factory=list)
    # per-priority-tier wait samples (tier 0 = most important); synthetic
    # workloads land entirely in tier 0
    waits_by_tier: dict[int, list[float]] = field(default_factory=dict)

    def observe_arrival(self, work: float = 0.0) -> None:
        self.arrived += 1
        self.admitted_work += float(work)

    def observe_completion(self, response: float, wait: float,
                           t_finish: float, tier: int = 0,
                           work: float = 0.0) -> None:
        self.completed += 1
        self.completed_work += float(work)
        self.responses.append(float(response))
        self.waits.append(float(wait))
        self.waits_by_tier.setdefault(int(tier), []).append(float(wait))
        self.makespan = max(self.makespan, float(t_finish))

    # -- derived -----------------------------------------------------------
    @property
    def mean_response(self) -> float:
        return float(np.mean(self.responses)) if self.responses else float("nan")

    @property
    def p99_response(self) -> float:
        return nearest_rank(np.asarray(self.responses), 99.0)

    @property
    def mean_wait(self) -> float:
        return float(np.mean(self.waits)) if self.waits else float("nan")

    @property
    def locality_hit_ratio(self) -> float:
        """Fraction of DAG-input service attempts that started on the node
        already holding the largest parent output (NaN without DAG work)."""
        n = self.locality_hits + self.locality_misses
        return self.locality_hits / n if n else float("nan")

    @property
    def cp_stretch(self) -> float:
        """Makespan normalized by the critical-path lower bound (>= 1 for a
        complete run; NaN when the workload declared no DAG)."""
        if self.cp_lower_bound > 0:
            return self.makespan / self.cp_lower_bound
        return float("nan")

    def wait_by_tier(self) -> dict[int, dict]:
        """Per-priority-tier wait statistics (mean / P99 / count), the
        quantity trace experiments compare policies on. Not part of
        :meth:`summary` — tiers only exist for trace workloads, and the
        canonical cross-backend schema stays scalar."""
        return {
            tier: {
                "mean_wait": float(np.mean(ws)),
                "p99_wait": nearest_rank(np.asarray(ws), 99.0),
                "completed": len(ws),
            }
            for tier, ws in sorted(self.waits_by_tier.items())
        }

    def summary(self) -> dict:
        """The full canonical schema — every accumulated quantity. This is
        the metric set ``repro_torch.lab.RunResult`` carries for every backend."""
        return {
            "arrived": self.arrived,
            "completed": self.completed,
            "makespan": self.makespan,
            "mean_response": self.mean_response,
            "p99_response": self.p99_response,
            "mean_wait": self.mean_wait,
            "migrations": self.migrations,
            "moved_packets": self.moved_packets,
            "moved_units": self.moved_units,
            "trigger_evals": self.trigger_evals,
            "trigger_fires": self.trigger_fires,
            "restarts": self.restarts,
            "failures": self.failures,
            "joins": self.joins,
            "resizes": self.resizes,
            "evictions": self.evictions,
            "admitted_work": self.admitted_work,
            "completed_work": self.completed_work,
            "wasted_work": self.wasted_work,
            "locality_hits": self.locality_hits,
            "locality_misses": self.locality_misses,
            # undefined ratios export as None, not NaN: NaN breaks dict
            # equality (the obs-changes-no-metric invariant) and is not
            # valid JSON anyway
            "locality_hit_ratio": (
                self.locality_hit_ratio
                if self.locality_hits + self.locality_misses else None),
            "dag_bytes_moved": self.dag_bytes_moved,
            "cp_lower_bound": self.cp_lower_bound,
            "cp_stretch": (self.cp_stretch
                           if self.cp_lower_bound > 0 else None),
        }
