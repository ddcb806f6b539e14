"""PSTS sequence -> data-shard balancing.

Variable-length documents make per-shard work uneven (attention adds a
quadratic term). Between steps, the host runs PSTS over per-sequence work
estimates with shard powers from the straggler monitor: slow hosts receive
proportionally less work — the paper's *adaptive* tau, applied to the input
pipeline. Hierarchical meshes balance across pods first, then across hosts
inside a pod (the paper's dimension recursion).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.hypergrid import HyperGrid
from ..core.psts import psts_schedule

__all__ = ["sequence_work", "balance_sequences", "BalanceResult"]


def sequence_work(lengths: np.ndarray, *, quad_norm: float = 4096.0,
                  quad_weight: float = 0.5) -> np.ndarray:
    """Work units beta_i per sequence: linear token cost plus the attention
    quadratic term (normalised so a quad_norm-token sequence costs
    ``(1 + quad_weight) * length``)."""
    lengths = np.asarray(lengths, dtype=np.float64)
    return lengths + quad_weight * lengths * (lengths / quad_norm)


@dataclass(frozen=True)
class BalanceResult:
    shard: np.ndarray          # (m,) destination shard per sequence
    shard_work: np.ndarray     # (n,) resulting work per shard
    target_work: np.ndarray    # (n,) power-proportional targets
    moved: int                 # sequences that changed shard

    @property
    def max_over_target(self) -> float:
        t = self.target_work.sum() / max(len(self.target_work), 1)
        return float(self.shard_work.max() / max(t, 1e-9))


def balance_sequences(
    lengths: np.ndarray,
    dims: tuple[int, ...],
    powers: np.ndarray | None = None,
    initial_shard: np.ndarray | None = None,
    **work_kw,
) -> BalanceResult:
    """Assign sequences to ``prod(dims)`` data shards, power-proportionally.

    dims: hierarchical shard grid, e.g. (pods, hosts_per_pod) — PSTS balances
    across pods before hosts (inter-pod before intra-pod traffic). powers
    default to uniform; feed ``StragglerMonitor.powers()`` for adaptive
    behaviour.
    """
    lengths = np.asarray(lengths)
    n = int(np.prod(dims))
    if powers is None:
        powers = np.ones(n, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    if powers.shape != (n,):
        raise ValueError(f"powers shape {powers.shape} != ({n},)")
    grid = HyperGrid(tuple(dims), powers)
    works = sequence_work(lengths, **work_kw)
    if initial_shard is None:
        # arrival order round-robin (the unbalanced baseline)
        initial_shard = np.arange(lengths.shape[0]) % n
    initial_shard = np.asarray(initial_shard, dtype=np.int64)
    res = psts_schedule(works, initial_shard, grid)
    return BalanceResult(
        shard=res.dest,
        shard_work=res.loads_after,
        target_work=res.targets,
        moved=int((res.dest != initial_shard).sum()),
    )
