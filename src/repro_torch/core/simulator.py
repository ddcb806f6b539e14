"""Heterogeneous-cluster simulator reproducing the paper's experiments (sec. 5).

The paper's setup: m = 4000 tasks, work units and packet counts drawn from
uniform / Poisson distributions, node powers in 1..10, cluster sizes 1..64,
staggered arrivals. We reproduce its measured quantities:

* Fig. 4 / Fig. 5 — wall-clock PSTS overhead vs. cluster size, d = 1 and d > 1,
* Fig. 6          — relative speedup of PSTS vs. cluster size,
* Table 6         — crossover point vs. cluster size for d = 1 and best d,
* Table 7         — crossover point for a single new arrival.

Absolute times are hardware-bound (the paper used 1999-era SPARC + Ethernet,
parameters p and q unreported), so the benchmarks assert/report the *shapes*:
overhead decreasing in n, higher-d strictly cheaper, speedup > 1 and
decreasing in n at fixed m, crossover decreasing with d and near-zero for
single arrivals.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .cost_model import crossover_imbalance, execution_time
from .hypergrid import HyperGrid, embed, optimal_dim
from .psts import psts_schedule
from .trigger import imbalance

__all__ = ["SimConfig", "SimResult", "simulate", "sweep_nodes", "crossover_table"]


@dataclass(frozen=True)
class SimConfig:
    """Calibration note: the paper reports crossover points of O(0.1..3)
    (Table 6), i.e. the PSTS overhead on their 1999 cluster was comparable to
    the *balanced makespan* — a fine-grain regime. p/q/t_task below are chosen
    so the simulated crossover magnitudes land in the paper's range (their own
    p, q values are unreported); every benchmark assertion is about *shape*
    (monotonicities, orderings), not absolute times.
    """

    n_nodes: int = 16
    d: int = 1                      # hyper-grid dimension (1 = bus)
    m_tasks: int = 4000             # paper: 4000
    work_dist: str = "uniform"      # "uniform" | "poisson" (paper's two)
    work_mean: float = 2.0          # fine-grain tasks (see note above)
    packet_mean: float = 8.0        # packets per task (transfer size mu_i)
    power_low: int = 1              # paper: powers normalised 1..10
    power_high: int = 10
    powers: tuple[float, ...] | None = None  # explicit node powers; None =
                                    # sample power_low..power_high (paper)
    p: float = 0.2                  # time per communication step
    q: float = 0.02                 # time per scan-add computation step
    t_task: float = 0.5             # per-task local placement time
    packets_per_step: float = 64.0  # packets moved per comm step (bandwidth)
    skew: float | None = None       # None = uniform placement (paper setup);
                                    # float = Dirichlet concentration (lower
                                    # = more skewed), for crossover studies
    seed: int = 0

    def with_d(self, d: int) -> "SimConfig":
        return replace(self, d=d)


@dataclass(frozen=True)
class SimResult:
    config: SimConfig
    dims: tuple[int, ...]
    makespan_before: float
    makespan_after: float
    overhead: float           # PSTS wall-clock cost, observed migrations
    overhead_apriori: float   # trigger-time estimate (scan-phase loads only)
    moved_tasks: int
    moved_units: float
    moved_packets: float
    imbalance_before: float
    imbalance_after: float
    residual: float

    @property
    def speedup(self) -> float:
        """Paper Fig. 6: response time without PSTS over with PSTS (incl. its
        own overhead)."""
        return self.makespan_before / (self.makespan_after + self.overhead)

    @property
    def crossover(self) -> float:
        """Imbalance level at which PSTS becomes beneficial (Table 6). Uses
        the a-priori overhead — the trigger must decide *before* migrating,
        from the scanned loads (expected excess units x packets/unit)."""
        return crossover_imbalance(self.overhead_apriori, self._w, self._pi)

    # filled by simulate()
    _w: float = field(default=0.0, repr=False)
    _pi: float = field(default=0.0, repr=False)


def _sample_workload(cfg: SimConfig, rng: np.random.Generator):
    if cfg.work_dist == "uniform":
        works = rng.uniform(1.0, 2.0 * cfg.work_mean - 1.0, size=cfg.m_tasks)
    elif cfg.work_dist == "poisson":
        works = 1.0 + rng.poisson(cfg.work_mean - 1.0, size=cfg.m_tasks)
    else:
        raise ValueError(f"unknown work distribution {cfg.work_dist!r}")
    packets = 1.0 + rng.poisson(cfg.packet_mean, size=cfg.m_tasks)
    return works.astype(np.float64), packets.astype(np.float64)


def _initial_placement(cfg: SimConfig, grid: HyperGrid,
                       rng: np.random.Generator) -> np.ndarray:
    """Initial placement. Default (skew=None) is uniform over active nodes —
    the paper's setup, where imbalance comes from power heterogeneity and
    sampling fluctuation. A Dirichlet ``skew`` concentration produces heavier
    imbalance for crossover studies (lower = more skewed)."""
    active = np.nonzero(grid.active)[0]
    if cfg.skew is None:
        return active[rng.integers(0, active.size, size=cfg.m_tasks)]
    probs = rng.dirichlet(np.full(active.size, cfg.skew))
    return active[rng.choice(active.size, size=cfg.m_tasks, p=probs)]


def simulate(cfg: SimConfig) -> SimResult:
    rng = np.random.default_rng(cfg.seed)
    if cfg.powers is not None:
        powers = np.asarray(cfg.powers, dtype=np.float64)
        if powers.shape != (cfg.n_nodes,):
            raise ValueError(f"powers has {powers.size} entries for "
                             f"n_nodes={cfg.n_nodes}")
    else:
        powers = rng.integers(cfg.power_low, cfg.power_high + 1,
                              size=cfg.n_nodes).astype(np.float64)
    grid = embed(powers, cfg.d)
    works, packets = _sample_workload(cfg, rng)
    node = _initial_placement(cfg, grid, rng)

    loads0 = np.bincount(node, weights=works, minlength=grid.capacity)
    active = grid.active
    makespan_before = float((loads0[active] / grid.powers[active]).max())
    imb_before = imbalance(loads0, grid.powers)

    res = psts_schedule(works, node, grid)
    makespan_after = float(
        (res.loads_after[active] / grid.powers[active]).max()
    )
    moved = res.dest != node
    moved_packets = float(packets[moved].sum())
    overhead = execution_time(
        grid.dims, grid.n_active, cfg.m_tasks, cfg.p, cfg.q,
        moved_packets=moved_packets, packets_per_step=cfg.packets_per_step,
        t_task=cfg.t_task,
    )
    # a-priori estimate, available right after the scan phase: excess units
    # above each node's fair share, converted to packets at the mean rate
    targets = works.sum() * grid.gamma
    excess_units = float(np.maximum(loads0 - targets, 0.0).sum())
    packets_per_unit = packets.sum() / works.sum()
    overhead_apriori = execution_time(
        grid.dims, grid.n_active, cfg.m_tasks, cfg.p, cfg.q,
        moved_packets=excess_units * packets_per_unit,
        packets_per_step=cfg.packets_per_step, t_task=cfg.t_task,
    )
    return SimResult(
        config=cfg,
        dims=grid.dims,
        makespan_before=makespan_before,
        makespan_after=makespan_after,
        overhead=overhead,
        overhead_apriori=overhead_apriori,
        moved_tasks=int(moved.sum()),
        moved_units=float(works[moved].sum()),
        moved_packets=moved_packets,
        imbalance_before=float(imb_before),
        imbalance_after=float(imbalance(res.loads_after, grid.powers)),
        residual=res.residual_imbalance,
        _w=float(works.sum()),
        _pi=grid.total_power,
    )


def sweep_nodes(cfg: SimConfig, nodes=(2, 4, 8, 16, 32, 64), d=None):
    """One row per cluster size (Fig. 4/5/6); d=None = paper-optimal."""
    out = []
    for n in nodes:
        dd = optimal_dim(n) if d is None else d
        out.append(simulate(replace(cfg, n_nodes=n, d=dd)))
    return out


def crossover_table(cfg: SimConfig, nodes=(2, 4, 8, 16, 32, 64)):
    """Paper Table 6: crossover point at d=1 vs. at the optimal dimension."""
    rows = []
    for n in nodes:
        r1 = simulate(replace(cfg, n_nodes=n, d=1))
        dopt = optimal_dim(n)
        ro = simulate(replace(cfg, n_nodes=n, d=dopt))
        rows.append({
            "nodes": n,
            "crossover_d1": r1.crossover,
            "crossover_dopt": ro.crossover,
            "d_opt": dopt,
        })
    return rows
