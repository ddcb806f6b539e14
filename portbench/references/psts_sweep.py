"""The plain reference of one PSTS sweep scenario, in NumPy.

A frozen copy of the semantics of ``repro_torch.runtime.vector_backend.
simulate_scalar``, written anew so that it imports nothing of the program:
B = 1, no power schedule, no probes. Time advances in slots of ``dt``; a
slot's arrivals go to nodes by the positional rule over deficit intervals
(the exclusive work prefix of all tasks against the prefix of the deficits'
shares), optionally FIFO-refined by the same-owner work ahead in the slot;
the crossover trigger redistributes queued work to fair shares; each node
drains ``power * dt``.

It takes the slot tables from the inputs itself, and works a slot's tasks
only, where ``simulate_scalar`` masks the whole row every slot: the
elementwise float64 arithmetic of a task is the same, and every sum that
feeds a branch (the prefixes, ``sum()``, the in-order queue adds) is taken
in the same order. ``dtype`` sets the precision of every float: the
benchmark's control runs it in float32.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["FIELDS", "simulate"]

FIELDS = ("mean_response", "p99_response", "makespan", "trigger_fires",
          "moved_units", "completed")

_TINY = 1e-12


def _nearest_rank(values: np.ndarray, pct: float) -> float:
    values = np.sort(values)
    n = values.shape[0]
    if n == 0:
        return float("nan")
    k = min(max(int(math.ceil(pct / 100.0 * n)), 1), n)
    return float(values[k - 1])


def _fifo_ahead(owner: np.ndarray, works: np.ndarray, n: int,
                dtype) -> np.ndarray:
    """Each task's same-owner work ahead of it in the slot, each owner's sum
    taken in task order: ``acc[owner] += work`` one task after another,
    worked a rank at a time (the k-th task of every owner together)."""
    order = np.argsort(owner, kind="stable")
    sorted_owner = owner[order]
    first = np.searchsorted(sorted_owner, sorted_owner, side="left")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0]) - first
    acc = np.zeros(n, dtype=dtype)
    ahead = np.zeros(owner.shape[0], dtype=dtype)
    for k in range(int(rank.max()) + 1 if rank.size else 0):
        sel = np.flatnonzero(rank == k)     # distinct owners
        ahead[sel] = acc[owner[sel]]
        acc[owner[sel]] += works[sel]
    return ahead


def simulate(slot: np.ndarray, works: np.ndarray, powers: np.ndarray,
             policy: dict, dtype=np.float64) -> dict:
    """The six metrics of one scenario: ``slot`` (M,) arrival slot of each
    task (``n_slots`` marks padding), ``works`` (M,), ``powers`` (n,)."""
    T, dt = int(policy["n_slots"]), dtype(policy["dt"])
    slot = np.asarray(slot)
    works = np.asarray(works, dtype=dtype)
    pw = np.asarray(powers, dtype=dtype)
    n = pw.shape[0]
    tiny = dtype(_TINY)
    zero = dtype(0.0)
    scan_steps = 2 * (n - 1)
    comm_cost = dtype(scan_steps * (policy["p"] + policy["q"]))
    per_unit = dtype(policy["packets_per_unit"])
    per_step = dtype(policy["packets_per_step"])
    p_cost = dtype(policy["p"])

    S = np.cumsum(works, dtype=dtype) - works       # exclusive work prefix
    by_slot = np.argsort(slot, kind="stable")
    starts = np.searchsorted(slot[by_slot], np.arange(T + 1))
    pi = pw.sum()
    queue = np.zeros(n, dtype=dtype)
    resp = np.zeros(works.shape[0], dtype=dtype)
    fires, moved, seen = 0, zero, zero
    backlog = np.zeros(T, dtype=dtype)
    for t in range(T):
        idx = by_slot[starts[t]:starts[t + 1]]      # this slot's tasks
        # the slot's total, summed in task order (np.add.at's order)
        tot = np.cumsum(works[idx], dtype=dtype)[-1] if idx.size else zero
        if tot > zero:
            fair = pw / pi * (queue.sum() + tot)
            deficit = np.maximum(fair - queue, zero)
            ds = deficit.sum()
            src, norm = (deficit, ds) if ds > zero else (pw, pi)
            share = src / norm
            lam = np.cumsum(share, dtype=dtype) - share
            base = S[idx].min()
            w = works[idx]
            frac = np.clip((S[idx] - base + dtype(0.5) * w) / tot,
                           zero, dtype(1.0) - tiny)
            owner = np.searchsorted(lam, frac, side="right") - 1
            ahead = (_fifo_ahead(owner, w, n, dtype)
                     if policy["fifo_dispatch"] else zero)
            resp[idx] = ((queue[owner] + ahead + w)
                         / np.maximum(pw[owner], tiny))
            np.add.at(queue, owner, w)
            seen += dtype(idx.size)
        if policy["rebalance"]:
            wq = queue.sum()
            t_bal = wq / pi if pi > zero else zero
            ratio = queue / np.maximum(pw, tiny)    # every power is > 0
            imb = ratio.max() / max(t_bal, tiny) - dtype(1.0)
            fair_q = pw / max(pi, tiny) * wq
            excess = np.maximum(queue - fair_q, zero).sum()
            overhead = (comm_cost + seen / dtype(n) * dtype(policy["t_task"])
                        + excess * per_unit / per_step * p_cost)
            cross = overhead / max(t_bal, tiny)
            if t_bal > tiny and imb > max(cross, dtype(policy["floor"])):
                queue = fair_q
                moved += excess
                fires += 1
        backlog[t] = queue.sum()
        queue = np.maximum(queue - pw * dt, zero)

    valid = slot < T
    count = float(valid.sum())
    drained = np.flatnonzero(backlog > tiny)
    return {
        "mean_response": float(resp.sum() / count) if count else float("nan"),
        "p99_response": _nearest_rank(resp[valid], 99.0),
        "makespan": float((drained[-1] + 1) * policy["dt"])
        if drained.size else 0.0,
        "trigger_fires": float(fires),
        "moved_units": float(moved),
        "completed": count,
    }
