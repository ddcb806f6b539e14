"""PSTS analytic cost model (paper section 4, eqs. 8-12, Prop. 4.1).

``S^k = 2 (n_1 + ... + n_k - k) (p + q)`` where p (resp. q) is the time of one
communication (resp. computation) step. Optimal embedding dimension is
``d* = ceil(log2 n)`` (all sides 2), giving ``S = 2 log2(n) (p + q)``.

One refinement used by the framework (not replacing the paper's model,
which is kept verbatim): ``execution_time`` adds the distributed destination
computation O(m / n) and the migration traffic — the terms that make the
paper's *measured* Fig. 4/5 curves decrease with the node count while eq. 11's
step count increases. The JAX package's TPU-calibrated cost constants are not
carried over: a GPU variant gets constants only once they have been measured.
"""

from __future__ import annotations

import math
from typing import Sequence

from .hypergrid import optimal_dim

__all__ = [
    "scan_steps",
    "step_cost",
    "optimal_cost",
    "execution_time",
    "crossover_imbalance",
]


def scan_steps(dims: Sequence[int]) -> int:
    """Communication (= computation) step count ``2 (sum n_i - k)`` (eq. 11)."""
    dims = tuple(dims)
    return 2 * (sum(dims) - len(dims))


def step_cost(dims: Sequence[int], p: float, q: float) -> float:
    """Paper eq. 11: ``S^k = 2 (sum n_i - k)(p + q)``."""
    return scan_steps(dims) * (p + q)


def optimal_cost(n: int, p: float, q: float) -> float:
    """Paper eq. 12 at ``d* = ceil(log2 n)``: ``2 log2(n)(p + q)``."""
    return 2 * optimal_dim(n) * (p + q)


def execution_time(
    dims: Sequence[int],
    n_active: int,
    m_tasks: int,
    p: float,
    q: float,
    moved_packets: float = 0.0,
    packets_per_step: float = 1.0,
    t_task: float = 1e-4,
) -> float:
    """Wall-clock PSTS overhead on a cluster (used by the simulator).

    step term        : eq. 11 (scans + broadcasts along every dimension;
                       p = comm step, q = scan-add comp step),
    local placement  : each node indexes/places its own ~m/n tasks in
                       parallel at ``t_task`` per task (paper alg. 1 steps
                       4-5, "highly parallel" — this term dominates the
                       paper's measured Fig. 4/5 curves and makes the total
                       decrease with the node count),
    migration term   : the paper's cluster is switched/shared Ethernet — one
                       collision domain, so migrations serialise rather than
                       riding n parallel links. This is what makes the
                       crossover point *grow* with n (Table 6) even at the
                       optimal dimension.
    """
    dims = tuple(dims)
    n_active = max(int(n_active), 1)
    steps = scan_steps(dims)
    local = (m_tasks / n_active) * t_task
    migration = (moved_packets / packets_per_step) * p
    return steps * (p + q) + local + migration


def crossover_imbalance(
    overhead: float,
    total_work: float,
    total_power: float,
) -> float:
    """Imbalance level above which running PSTS is beneficial (paper sec. 5).

    With imbalance ``I = T_now / T_balanced - 1`` (``T_balanced = W / Pi``),
    the gain of balancing is ``I * W / Pi``; the crossover point is where the
    gain equals the algorithm overhead.
    """
    if total_work <= 0:
        return math.inf
    t_balanced = total_work / total_power
    return overhead / t_balanced
