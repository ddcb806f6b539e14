"""Pluggable placement/rebalance policies for the cluster runtime.

A policy answers two questions: where does a new arrival go (``on_arrival``)
and, at periodic trigger evaluations, should queued work be rebalanced
(``wants_rebalance``). The engine executes the mechanics (queues, migrations,
completions); policies only decide. All policies share one ``Metrics``
accumulator per run, so comparisons (paper section 5's methodology extended
to competing baselines) are on identical quantities.

Registry::

    make_policy("psts", floor=0.1)   # or "random" | "round_robin" | "jsq"
                                     # | "arrival_only" | "replica"

``positional_arrival`` is the paper's per-arrival fast path (Table 7): the
new task lands at the midpoint of the deficit intervals computed from the
load and power scans — no global reshuffle.

The policies decide for the event engine (``runtime.ClusterRuntime``); the
batched backend reads ``PstsPolicy``'s cost constants and defaults, and
``sched.request_sched`` registers ``"replica"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.pslb import owner_of_fraction
from ..core.scan import exclusive_scan_np
from ..core.trigger import CrossoverTrigger, TriggerDecision

__all__ = [
    "Policy",
    "POLICIES",
    "register",
    "make_policy",
    "positional_arrival",
    "RandomPolicy",
    "RoundRobinPolicy",
    "WeightedJsqPolicy",
    "ArrivalOnlyPolicy",
    "PstsPolicy",
    "LocalityPolicy",
]


def positional_arrival(loads: np.ndarray, powers: np.ndarray,
                       work: float, mask: np.ndarray | None = None) -> int:
    """Place one arrival by the positional rule over deficit intervals.

    ``deficit_i = max(gamma_i * (W + work) - load_i, 0)``; the task's single
    work span maps to the midpoint fraction 0.5 of the deficit scan. When the
    cluster is perfectly full (no deficit anywhere) fall back to the least
    normalised load among active nodes.

    ``mask`` restricts the rule to a feasible subset (placement
    constraints): infeasible nodes contribute no power and no load to the
    balance — the task is positioned within its feasible sub-cluster.
    """
    loads = np.asarray(loads, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        powers = np.where(mask, powers, 0.0)
        loads = np.where(mask, loads, 0.0)
    pi = powers.sum()
    if pi <= 0:
        raise ValueError("no active nodes to place on")
    deficit = np.maximum(powers / pi * (loads.sum() + work) - loads, 0.0)
    if deficit.sum() <= 0:
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(powers > 0,
                             loads / np.maximum(powers, 1e-12), np.inf)
        return int(np.argmin(ratio))
    lam = exclusive_scan_np(deficit / deficit.sum())
    return int(owner_of_fraction(lam, np.array([0.5]))[0])


class Policy:
    """Base class; subclasses register themselves under ``POLICIES``."""

    name: str = "?"
    uses_trigger: bool = False

    def on_arrival(self, work: float, packets: float,
                   view) -> int:
        raise NotImplementedError

    def wants_rebalance(self, view, m_queued: int,
                        packets_estimate: float) -> TriggerDecision | None:
        """Return a TriggerDecision to record an evaluation, or None to skip.
        The engine migrates queued tasks iff ``decision.trigger``."""
        return None


POLICIES: dict[str, type[Policy]] = {}


def register(name: str):
    def deco(cls: type[Policy]) -> type[Policy]:
        cls.name = name
        POLICIES[name] = cls
        return cls
    return deco


def make_policy(spec: str | Policy, **kwargs) -> Policy:
    if isinstance(spec, Policy):
        return spec
    if spec == "replica" and spec not in POLICIES:
        # the serving request scheduler registers itself on import
        from ..sched import request_sched  # noqa: F401
    if spec not in POLICIES:
        raise ValueError(f"unknown policy {spec!r}; have {sorted(POLICIES)}")
    return POLICIES[spec](**kwargs)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def _allowed(view) -> np.ndarray:
    """Active nodes intersected with the decision's feasibility mask (the
    engine supplies ``view.feasible`` for constrained trace tasks)."""
    allowed = view.grid.active
    if view.feasible is not None:
        allowed = allowed & view.feasible
    return allowed


@register("random")
@dataclass
class RandomPolicy(Policy):
    """Uniform over active (feasible) nodes — the no-information baseline."""

    def on_arrival(self, work, packets, view):
        nodes = np.flatnonzero(_allowed(view))
        if nodes.size == 0:
            raise ValueError("no active nodes to place on")
        return int(nodes[view.rng.integers(0, nodes.size)])


@register("round_robin")
@dataclass
class RoundRobinPolicy(Policy):
    """Cycle over active (feasible) nodes; blind to load and power."""

    _i: int = 0

    def on_arrival(self, work, packets, view):
        nodes = np.flatnonzero(_allowed(view))
        if nodes.size == 0:
            raise ValueError("no active nodes to place on")
        node = int(nodes[self._i % nodes.size])
        self._i += 1
        return node


@register("jsq")
@dataclass
class WeightedJsqPolicy(Policy):
    """Power-weighted join-shortest-queue: argmin (load + work) / tau —
    greedy earliest-completion, the strong centralized baseline."""

    def on_arrival(self, work, packets, view):
        powers = np.where(_allowed(view), view.grid.powers, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            eta = np.where(powers > 0,
                           (view.loads + work) / np.maximum(powers, 1e-12),
                           np.inf)
        return int(np.argmin(eta))


@register("arrival_only")
@dataclass
class ArrivalOnlyPolicy(Policy):
    """The paper's per-arrival positional rule, never rebalancing: what you
    get if the crossover trigger is disabled (paper Table 7 fast path)."""

    def on_arrival(self, work, packets, view):
        return positional_arrival(view.loads, view.grid.powers, work,
                                  mask=view.feasible)


@register("psts")
@dataclass
class PstsPolicy(ArrivalOnlyPolicy):
    """Place-on-arrival plus trigger-gated PSTS rebalancing of queued work —
    the paper's full operating policy. ``p``/``q``/``t_task`` are the
    crossover cost constants; ``floor`` is the hysteresis floor that stops
    re-triggering on the indivisibility residual."""

    p: float = 1e-3
    q: float = 1e-4
    t_task: float = 1e-4
    packets_per_step: float = 64.0
    floor: float = 0.05
    uses_trigger = True

    def wants_rebalance(self, view, m_queued, packets_estimate):
        trigger = CrossoverTrigger(
            view.grid, p=self.p, q=self.q, t_task=self.t_task,
            packets_per_step=self.packets_per_step, floor=self.floor)
        return trigger.evaluate(view.loads, m_tasks=max(m_queued, 1),
                                moved_packets_estimate=packets_estimate)


@register("locality")
@dataclass
class LocalityPolicy(PstsPolicy):
    """Data-locality-aware placement for DAG workloads (cf. Dask's
    worker-objective heuristic): a task with parent outputs lands where
    ``(load + work) / power + transfer`` is smallest — the estimated finish
    accounting for both queueing *and* the input fetch the engine will
    charge. Tasks without DAG inputs fall back to the positional rule, and
    the trigger-gated PSTS rebalance of queued (released) work is
    inherited unchanged, so on a bag of independent tasks this *is* PSTS.

    ``coalloc=True`` co-allocates sibling groups (Moise et al.): candidates
    are restricted to the nodes with the *minimal* transfer cost — children
    of one parent pack onto the node holding its output until queueing
    there is hopeless only if another node ties on transfer.
    """

    coalloc: bool = False

    def on_arrival(self, work, packets, view):
        if view.xfer is None:
            return super().on_arrival(work, packets, view)
        allowed = _allowed(view)
        if not allowed.any():
            raise ValueError("no active nodes to place on")
        powers = np.where(allowed, view.grid.powers, 0.0)
        xfer = np.where(allowed, view.xfer, np.inf)
        if self.coalloc:
            cand = allowed & (xfer <= xfer.min())
            powers = np.where(cand, powers, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            eta = np.where(powers > 0,
                           (view.loads + work) / np.maximum(powers, 1e-12)
                           + xfer,
                           np.inf)
        return int(np.argmin(eta))
