"""PSLB — Positional Scan Load Balancing on 1-D hyper-grids (paper section 3.1).

The positional rule (validated against the paper's worked example, section 4.2):

* every node knows the load to its left ``S_i`` (exclusive load scan), the
  grid total ``W`` and the power prefix ``lambda_i`` (exclusive scan of the
  normalised powers ``gamma``),
* work unit ``j`` (0-indexed in scan order) belongs to the node whose power
  interval ``[lambda_i * W, lambda_{i+1} * W)`` contains ``j``,
* an *indivisible* task owns the interval ``[start, start + beta)``; it is
  placed on the node owning its midpoint (the paper leaves the tie rule open:
  "a decision has to be made on whether the whole task has to migrate or
  not" — midpoint ownership minimises the task's distance to its unit span).

All functions are host-side numpy (exact, used by the schedulers).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .scan import exclusive_scan_np

__all__ = [
    "owner_of_fraction",
    "apportion",
    "pslb_assign",
    "distribute_stream",
    "split_keep_migrate",
    "PslbResult",
]

_EPS = 1e-12


def owner_of_fraction(lam: np.ndarray, frac: np.ndarray) -> np.ndarray:
    """Node owning fraction ``frac`` in [0, 1) given power prefix ``lam``.

    ``lam`` is the exclusive scan of normalised powers (paper eq. 7). Nodes
    with zero power own empty intervals and are never selected.
    """
    frac = np.clip(np.asarray(frac, dtype=np.float64), 0.0, 1.0 - _EPS)
    return np.searchsorted(lam, frac, side="right") - 1


def apportion(total: int, gamma: np.ndarray) -> np.ndarray:
    """Integer proportional shares via largest remainder (sums to ``total``)."""
    gamma = np.asarray(gamma, dtype=np.float64)
    raw = gamma * total
    base = np.floor(raw).astype(np.int64)
    rem = total - int(base.sum())
    if rem > 0:
        order = np.argsort(-(raw - base), kind="stable")
        base[order[:rem]] += 1
    return base


@dataclass(frozen=True)
class PslbResult:
    dest: np.ndarray          # (m,) destination node per task
    loads_before: np.ndarray  # (n,) work units per node before
    loads_after: np.ndarray   # (n,) work units per node after
    moved_tasks: int
    moved_units: float


def pslb_assign(
    works: np.ndarray,
    node: np.ndarray,
    powers: np.ndarray,
) -> PslbResult:
    """Balance indivisible tasks on a 1-D grid by the positional scan rule.

    ``works``: (m,) work units per task (beta_i); ``node``: (m,) current node;
    ``powers``: (n,) processing power per node (tau_i, 0 for virtual nodes).
    """
    works = np.asarray(works, dtype=np.float64)
    node = np.asarray(node, dtype=np.int64)
    powers = np.asarray(powers, dtype=np.float64)
    n = powers.shape[0]
    m = works.shape[0]
    loads_before = np.bincount(node, weights=works, minlength=n)

    pi = powers.sum()
    if pi <= 0:
        raise ValueError("grid has zero total power")
    lam = exclusive_scan_np(powers / pi)

    if m == 0:
        return PslbResult(np.zeros(0, np.int64), loads_before, loads_before, 0, 0.0)

    total = works.sum()
    if total <= 0:
        return PslbResult(node.copy(), loads_before, loads_before, 0, 0.0)

    # scan order: by current node, stable within node (preserves locality)
    order = np.argsort(node, kind="stable")
    start = exclusive_scan_np(works[order])
    frac = (start + works[order] / 2.0) / total
    dest_ordered = owner_of_fraction(lam, frac)
    dest = np.empty(m, dtype=np.int64)
    dest[order] = dest_ordered

    loads_after = np.bincount(dest, weights=works, minlength=n)
    moved = dest != node
    return PslbResult(
        dest=dest,
        loads_before=loads_before,
        loads_after=loads_after,
        moved_tasks=int(moved.sum()),
        moved_units=float(works[moved].sum()),
    )


def distribute_stream(works: np.ndarray, powers: np.ndarray) -> np.ndarray:
    """Place an ordered incoming task stream onto nodes proportionally to power.

    This is the receiver-side rule of the worked example (Table 5): incoming
    unit at stream position p maps to fraction ``p / total`` against the
    receiver grid's own ``lambda``. Returns destination node per task.
    """
    works = np.asarray(works, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    pi = powers.sum()
    if pi <= 0:
        raise ValueError("receiver grid has zero total power")
    total = works.sum()
    if works.shape[0] == 0 or total <= 0:
        return np.zeros(works.shape[0], dtype=np.int64)
    lam = exclusive_scan_np(powers / pi)
    start = exclusive_scan_np(works)
    frac = (start + works / 2.0) / total
    return owner_of_fraction(lam, frac)


def split_keep_migrate(
    works: np.ndarray,
    node: np.ndarray,
    loads: np.ndarray,
    keep_total: float,
) -> np.ndarray:
    """Sender-side split (paper Table 4): each node keeps the same fraction
    ``keep_total / W_local`` of its own load; within a node the *kept* portion
    is the prefix of the local task stream (midpoint rule), preserving
    locality. Returns a boolean mask, True = task stays in this hyper-grid.
    """
    works = np.asarray(works, dtype=np.float64)
    node = np.asarray(node, dtype=np.int64)
    loads = np.asarray(loads, dtype=np.float64)
    w_local = loads.sum()
    if w_local <= 0:
        return np.ones(works.shape[0], dtype=bool)
    rho = np.clip(keep_total / w_local, 0.0, 1.0)

    # per-node local stream offsets (stable order within node)
    order = np.argsort(node, kind="stable")
    sorted_node = node[order]
    sorted_works = works[order]
    run_start = exclusive_scan_np(sorted_works)
    node_base = exclusive_scan_np(np.bincount(node, weights=works,
                                              minlength=loads.shape[0]))
    local_off = run_start - node_base[sorted_node]
    keep_units = rho * loads[sorted_node]
    keep_sorted = (local_off + sorted_works / 2.0) < keep_units + _EPS
    keep = np.empty(works.shape[0], dtype=bool)
    keep[order] = keep_sorted
    return keep
