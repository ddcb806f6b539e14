"""PSTS — Positional Scan Task Scheduling (paper section 3.2, algorithm 2).

Recursive balancing over a hyper-grid:

1. at the current (highest) dimension, treat each (d-1)-dimensional slice as a
   hyper-node; scan slice loads ``W_r`` and slice powers ``Pi_r``,
2. fair share ``fair_r = W * Pi_r / Pi`` marks each slice *sender* or
   *receiver* (paper: "after these scans each hyper-grid knows whether it is a
   receiver or a sender"),
3. senders keep ``fair_r`` work units — every node keeps the same fraction of
   its local load (Table 4) — and emit the rest as an ordered task stream,
4. the concatenated sender stream is carved into receiver deficit intervals by
   the positional rule (the inter-hyper-grid migration),
5. receivers place incoming tasks onto their nodes proportionally to power
   (Table 5) and balance their *local* load recursively; senders balance the
   kept load recursively, down to 1-D grids where PSLB applies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hypergrid import HyperGrid
from .pslb import (
    distribute_stream,
    owner_of_fraction,
    pslb_assign,
    split_keep_migrate,
)
from .scan import exclusive_scan_np

__all__ = ["ScheduleResult", "sender_receiver", "psts_schedule"]


@dataclass(frozen=True)
class ScheduleResult:
    dest: np.ndarray            # (m,) destination node (row-major grid index)
    loads_before: np.ndarray    # (capacity,) work units per node
    loads_after: np.ndarray
    targets: np.ndarray         # (capacity,) ideal loads W * gamma_i
    moved_tasks: int
    moved_units: float
    inter_grid_units: np.ndarray  # units crossing slice boundaries, per level

    @property
    def residual_imbalance(self) -> float:
        """max over active nodes of |load - target| / mean target; bounded by
        the largest task size because tasks are indivisible (paper section 4.2:
        "the system may not be perfectly balanced")."""
        mask = self.targets > 0
        if not mask.any():
            return 0.0
        mean = self.targets[mask].mean()
        return float(np.abs(self.loads_after[mask] - self.targets[mask]).max() / mean)


def sender_receiver(loads: np.ndarray, powers: np.ndarray):
    """Fair shares and sender/receiver classification for sibling hyper-grids.

    Returns ``(fair, excess)`` where ``excess > 0`` marks a sender and
    ``excess < 0`` a receiver (paper step: least index ``lambda <= i/W``).
    """
    loads = np.asarray(loads, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    pi = powers.sum()
    if pi <= 0:
        raise ValueError("zero total power")
    fair = loads.sum() * powers / pi
    return fair, loads - fair


def psts_schedule(works, node, grid: HyperGrid) -> ScheduleResult:
    """Run PSTS over ``grid``; returns final task placement and statistics."""
    works = np.asarray(works, dtype=np.float64)
    node = np.asarray(node, dtype=np.int64)
    if works.shape != node.shape:
        raise ValueError("works and node must have the same shape")
    if works.shape[0] and (node.min() < 0 or node.max() >= grid.capacity):
        raise ValueError("task placement outside the hyper-grid")

    loads_before = np.bincount(node, weights=works, minlength=grid.capacity)
    level_units = np.zeros(max(grid.ndim - 1, 0), dtype=np.float64)
    dest = _balance(works, node, grid, level_units, level=0)
    loads_after = np.bincount(dest, weights=works, minlength=grid.capacity)
    targets = works.sum() * grid.gamma
    moved = dest != node
    return ScheduleResult(
        dest=dest,
        loads_before=loads_before,
        loads_after=loads_after,
        targets=targets,
        moved_tasks=int(moved.sum()),
        moved_units=float(works[moved].sum()),
        inter_grid_units=level_units,
    )


def _balance(
    works: np.ndarray,
    node: np.ndarray,
    grid: HyperGrid,
    level_units: np.ndarray,
    level: int,
) -> np.ndarray:
    m = works.shape[0]
    dest = np.empty(m, dtype=np.int64)
    if m == 0:
        return dest
    if grid.ndim == 1 or grid.capacity == 1:
        if grid.total_power <= 0:
            raise ValueError("cannot balance a fully-virtual hyper-grid")
        return pslb_assign(works, node, grid.powers).dest

    p = grid.dims[0]
    slice_size = grid.capacity // p
    slices = grid.slices()
    sid = node // slice_size
    local = node - sid * slice_size

    w_slice = np.bincount(sid, weights=works, minlength=p)
    pi_slice = np.array([s.total_power for s in slices])
    fair, excess = sender_receiver(w_slice, pi_slice)

    # ---- sender side: split keep/migrate, build the ordered outgoing stream
    keep_mask = np.ones(m, dtype=bool)
    stream_chunks: list[np.ndarray] = []  # task indices, in slice order
    for r in range(p):
        in_r = np.nonzero(sid == r)[0]
        if in_r.size == 0 or excess[r] <= 0:
            continue
        loads_r = np.bincount(local[in_r], weights=works[in_r],
                              minlength=slice_size)
        keep_r = split_keep_migrate(works[in_r], local[in_r], loads_r, fair[r])
        keep_mask[in_r[~keep_r]] = False
        # outgoing tasks in (node, stable) order — the scan order
        out_idx = in_r[~keep_r]
        if out_idx.size:
            order = np.argsort(local[out_idx], kind="stable")
            stream_chunks.append(out_idx[order])

    if stream_chunks:
        stream = np.concatenate(stream_chunks)
        out_works = works[stream]
        total_out = out_works.sum()
        level_units[level] += total_out
        deficit = np.maximum(-excess, 0.0)
        total_deficit = deficit.sum()
        # carve the stream into receiver intervals (positional rule)
        lam_recv = exclusive_scan_np(deficit / total_deficit)
        pos = exclusive_scan_np(out_works) + out_works / 2.0
        recv_slice = owner_of_fraction(lam_recv, pos / total_out)
        # receiver side: place incoming proportionally to power (Table 5)
        for r in np.unique(recv_slice):
            inc = stream[recv_slice == r]
            dest[inc] = r * slice_size + distribute_stream(
                works[inc], slices[r].powers
            )
    # ---- recurse on the load that stays within each slice
    for r in range(p):
        in_r = np.nonzero((sid == r) & keep_mask)[0]
        if in_r.size == 0:
            continue
        sub = _balance(works[in_r], local[in_r], slices[r], level_units,
                       level + 1)
        dest[in_r] = r * slice_size + sub
    return dest
