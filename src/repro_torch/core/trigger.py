"""Crossover-point trigger (paper section 5, Tables 6-7).

Any dynamic scheduler pays its own overhead; the paper's crossover point is
the imbalance level at which triggering PSTS starts to pay. The framework
evaluates this between steps (host-side, cheap) for the request scheduler and
the straggler rebalancer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cost_model import crossover_imbalance, execution_time
from .hypergrid import HyperGrid

__all__ = ["imbalance", "CrossoverTrigger", "TriggerDecision"]


def imbalance(loads: np.ndarray, powers: np.ndarray) -> float:
    """``I = T_now / T_balanced - 1``; 0 means perfectly power-proportional.

    ``T_now = max_i w_i / tau_i`` over active nodes, ``T_balanced = W / Pi``.
    """
    loads = np.asarray(loads, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    active = powers > 0
    if loads[~active].sum() > 0:
        return np.inf  # work stranded on failed/virtual nodes
    pi = powers[active].sum()
    w = loads.sum()
    if w <= 0 or pi <= 0:
        return 0.0
    t_now = (loads[active] / powers[active]).max()
    t_bal = w / pi
    return float(t_now / t_bal - 1.0)


@dataclass(frozen=True)
class TriggerDecision:
    trigger: bool
    imbalance: float
    crossover: float
    overhead: float
    gain: float


@dataclass(frozen=True)
class CrossoverTrigger:
    """Decides whether rebalancing pays (paper crossover criterion).

    p, q: communication/computation step costs in the same time unit as the
    workload (work units / power). ``packets_per_step`` converts migration
    packets to communication steps.
    """

    grid: HyperGrid
    p: float
    q: float
    packets_per_step: float = 1.0
    t_task: float = 1e-4
    floor: float = 0.0   # hysteresis: never trigger below this imbalance,
                         # even when the crossover is lower (prevents
                         # thrashing on the indivisibility residual)

    def evaluate(
        self,
        loads: np.ndarray,
        m_tasks: int,
        moved_packets_estimate: float = 0.0,
    ) -> TriggerDecision:
        loads = np.asarray(loads, dtype=np.float64)
        i_now = imbalance(loads, self.grid.powers)
        overhead = execution_time(
            self.grid.dims,
            self.grid.n_active,
            m_tasks,
            self.p,
            self.q,
            moved_packets=moved_packets_estimate,
            packets_per_step=self.packets_per_step,
            t_task=self.t_task,
        )
        w, pi = loads.sum(), self.grid.total_power
        cross = crossover_imbalance(overhead, w, pi)
        gain = (i_now * w / pi) if np.isfinite(i_now) else np.inf
        return TriggerDecision(
            trigger=bool(i_now > max(cross, self.floor)),
            imbalance=float(i_now),
            crossover=float(cross),
            overhead=float(overhead),
            gain=float(gain),
        )

    def arrival_crossover(
        self,
        mean_work: float,
        m_tasks: int,
        packets_per_task: float = 8.0,
    ) -> float:
        """Paper Table 7: crossover for a single new arrival.

        An arrival rides the next periodic PSTS run, so its *marginal*
        overhead is the migration of one task plus its 1/m share of the
        scan + placement phases; normalised by the mean task response time
        (``mean_work / mean_power``). This reproduces the paper's
        ``C + B/n`` shape: small at every cluster size and decreasing with
        n — hence the paper's conclusion that PSTS can run on every arrival.
        """
        full = execution_time(
            self.grid.dims, self.grid.n_active, m_tasks, self.p, self.q,
            t_task=self.t_task,
        )
        mig_one = (packets_per_task / self.packets_per_step) * self.p
        overhead = mig_one + full / max(m_tasks, 1)
        mean_power = float(self.grid.powers[self.grid.active].mean())
        response = mean_work / mean_power
        return overhead / response
