"""PSTS analytic cost model (paper section 4, eqs. 8-12, Prop. 4.1).

``S^k = 2 (n_1 + ... + n_k - k) (p + q)`` where p (resp. q) is the time of one
communication (resp. computation) step. Optimal embedding dimension is
``d* = ceil(log2 n)`` (all sides 2), giving ``S = 2 log2(n) (p + q)``.

One refinement used by the framework (not replacing the paper's model,
which is kept verbatim): ``execution_time`` adds the distributed destination
computation O(m / n) and the migration traffic — the terms that make the
paper's *measured* Fig. 4/5 curves decrease with the node count while eq. 11's
step count increases. ``GpuCostModel`` costs one rebalance on a mesh of
H100 SXM cards: axis scans, the migration all-to-all and local placement.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from .hypergrid import factorize, optimal_dim

__all__ = [
    "scan_steps",
    "step_cost",
    "optimal_cost",
    "execution_time",
    "crossover_imbalance",
    "GpuCostModel",
    "NDR_LINK_BW",
    "FP64_FLOP_RATE",
]

# NVIDIA data-sheet figures for an H100 SXM card (700 W). The link is one
# ConnectX-7 InfiniBand NDR port per card, 400 Gb/s each way (DGX H100 data
# sheet: eight ports for eight cards); ``launch.roofline`` reads it too.
NDR_LINK_BW = 50e9      # bytes/s each way
# float64 without the tensor cores (H100 SXM data sheet): placement runs in
# float64.
FP64_FLOP_RATE = 34e12  # FLOP/s


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


@dataclass(frozen=True)
class GpuCostModel:
    """The same recursion on H100 SXM cards. A mesh-axis scan is
    ``core.scan.axis_exclusive_scan``'s ladder: ceil(log2 n_i) rounds of
    ``batch_isend_irecv`` along a ``DeviceMesh`` dimension; migration is an
    all-to-all across the axis links.

    alpha: per-hop latency of the link (s). No data-sheet figure is
    published for it, so it has no default and the caller states it.
    link_bw: bytes/s per link; flop_rate: per-card FLOP/s for the local
    placement computation.
    """

    alpha: float
    link_bw: float = NDR_LINK_BW
    flop_rate: float = FP64_FLOP_RATE

    def scan_time(self, dims: Sequence[int], payload_bytes: float) -> float:
        hops = sum(math.ceil(math.log2(n)) for n in dims if n > 1)
        return hops * (self.alpha + payload_bytes / self.link_bw)

    def migrate_time(self, dims: Sequence[int], moved_bytes: float) -> float:
        # all_to_all over the slowest axis: bisection-limited
        if not dims:
            return 0.0
        links = max(math.prod(dims) // max(max(dims), 1), 1)
        return moved_bytes / (links * self.link_bw) + self.alpha * len(dims)

    def rebalance_cost(
        self,
        n: int,
        d: int | None = None,
        scan_payload_bytes: float = 64.0,
        moved_bytes: float = 0.0,
        m_tasks: int = 0,
    ) -> float:
        dims = factorize(n, optimal_dim(n) if d is None else d)
        local = 50.0 * m_tasks / max(n, 1) / self.flop_rate  # ~50 flops/task
        return self.scan_time(dims, scan_payload_bytes) + \
            self.migrate_time(dims, moved_bytes) + local
