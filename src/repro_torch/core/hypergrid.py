"""Hyper-grid model (paper section 2.1 and 4.1).

A cluster ``G(V, E)`` is embedded into a d-dimensional grid; nodes that do not
correspond to a physical node are *virtual* (processing power 0), so the
balancing algorithm runs unchanged on incomplete grids. Proposition 4.1: the
cost-optimal dimension is ``ceil(log2(n))`` (all sides 2).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = ["HyperGrid", "optimal_dim", "factorize", "embed"]


def optimal_dim(n: int) -> int:
    """Paper Prop. 4.1: ``d* = ceil(log2(n))``."""
    if n < 1:
        raise ValueError(f"need at least one node, got {n}")
    if n == 1:
        return 1
    return int(math.ceil(math.log2(n)))


def factorize(n: int, d: int) -> tuple[int, ...]:
    """Choose grid side lengths ``(n_1, ..., n_d)`` to embed ``n`` nodes.

    Minimises (1) virtual-node count ``prod(n_i) - n`` and then (2) the paper's
    step cost ``sum(n_i)`` (eq. 11). Sides are as equal as possible: each side
    is ``ceil(n ** (1/d))`` or one less, trimmed greedily while the product
    still covers ``n``.
    """
    if d < 1:
        raise ValueError(f"dimension must be >= 1, got {d}")
    if d == 1:
        return (n,)
    base = max(2, int(math.ceil(n ** (1.0 / d))))
    sides = [base] * d
    # greedily shrink sides while still covering n (reduces both objectives)
    changed = True
    while changed:
        changed = False
        for i in range(d):
            if sides[i] > 1:
                trial = sides.copy()
                trial[i] -= 1
                if math.prod(trial) >= n:
                    sides = trial
                    changed = True
    return tuple(sorted(sides, reverse=True))


@dataclass(frozen=True)
class HyperGrid:
    """A d-dimensional hyper-grid over ``capacity = prod(dims)`` slots.

    ``powers`` holds per-slot processing power tau (paper: work units per unit
    time); virtual slots have power 0. Node order is row-major (C order), which
    fixes the 1-D scan order the positional rule uses.
    """

    dims: tuple[int, ...]
    powers: np.ndarray  # float64 (capacity,)
    active: np.ndarray = field(default=None)  # bool (capacity,)

    def __post_init__(self):
        powers = np.asarray(self.powers, dtype=np.float64)
        if powers.shape != (self.capacity,):
            raise ValueError(
                f"powers shape {powers.shape} != capacity ({self.capacity},)"
            )
        active = self.active
        if active is None:
            active = powers > 0
        active = np.asarray(active, dtype=bool)
        if (powers[~active] != 0).any():
            raise ValueError("virtual nodes must have zero processing power")
        object.__setattr__(self, "powers", powers)
        object.__setattr__(self, "active", active)

    # -- structure ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(math.prod(self.dims))

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def total_power(self) -> float:
        """Pi = sum(tau_i) (paper eq. 3)."""
        return float(self.powers.sum())

    @property
    def gamma(self) -> np.ndarray:
        """Normalised powers gamma_i = tau_i / Pi (paper section 3.2)."""
        pi = self.total_power
        if pi <= 0:
            raise ValueError("hyper-grid has zero total power")
        return self.powers / pi

    def coords(self, index: int | np.ndarray) -> np.ndarray:
        """Row-major index -> grid coordinates ``[i_1, ..., i_d]``."""
        return np.stack(np.unravel_index(index, self.dims), axis=-1)

    def index(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.dims))

    # -- recursion ----------------------------------------------------------
    def slices(self) -> list["HyperGrid"]:
        """Split along the leading dimension into ``dims[0]`` sub-hyper-grids
        (paper eq. 1: ``G^i = {G^{i-1}_1, ..., G^{i-1}_{p_i}}``)."""
        if self.ndim == 1:
            raise ValueError("1-D hyper-grid has no sub-hyper-grids")
        sub = self.dims[1:]
        size = int(math.prod(sub))
        return [
            HyperGrid(sub, self.powers[r * size : (r + 1) * size],
                      self.active[r * size : (r + 1) * size])
            for r in range(self.dims[0])
        ]

    def fail(self, index: int) -> "HyperGrid":
        """Elasticity hook: a failed node becomes a *virtual* node (tau = 0),
        exactly the paper's incomplete-grid treatment (section 4.1)."""
        powers = self.powers.copy()
        active = self.active.copy()
        powers[index] = 0.0
        active[index] = False
        return HyperGrid(self.dims, powers, active)


def embed(powers: Sequence[float], d: int | None = None) -> HyperGrid:
    """Embed ``n`` physical nodes into a d-D hyper-grid (d defaults to the
    paper-optimal ``ceil(log2 n)``), padding with virtual nodes."""
    powers = np.asarray(list(powers), dtype=np.float64)
    n = powers.shape[0]
    if d is None:
        d = optimal_dim(n)
    dims = factorize(n, d)
    cap = int(math.prod(dims))
    padded = np.zeros(cap, dtype=np.float64)
    padded[:n] = powers
    active = np.zeros(cap, dtype=bool)
    active[:n] = True
    return HyperGrid(dims, padded, active)
