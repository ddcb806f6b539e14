"""Top-level positional balancer: the paper's rule at recursion level k+1.

Inside a cluster the positional rule places work over a scan of per-node
deficit intervals. A federation applies the identical rule one level up:
each member *cluster* collapses to one slot of a 1-D grid whose power is the
cluster's total power Pi_c and whose load is its outstanding work W_c — the
paper's recursion over shrinking-dimension hyper-grids extended upward by
one dimension. Destinations are chosen by the same exclusive-scan /
owner-of-fraction machinery (``core.scan``, ``core.pslb``) the in-cluster
rule uses, masked to the clusters actually reachable over a WAN link.

What the positional rule does NOT know about is WAN cost, so every proposed
transfer passes a reservation-style admission check: the predicted
completion-time gain (source drain time minus destination drain time minus
link delay) must clear ``admission_margin``, otherwise the task stays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.pslb import owner_of_fraction
from ..core.scan import exclusive_scan_np

__all__ = ["choose_destination", "choose_victim", "admit", "ExchangeStats"]

_TINY = 1e-12


def choose_destination(loads: np.ndarray, powers: np.ndarray,
                       reachable: np.ndarray, work: float) -> int:
    """Pick the member cluster a surplus task of ``work`` units moves to.

    ``loads``/``powers`` are per-cluster totals (W_c, Pi_c); ``reachable``
    masks the clusters linked to the source. Deficits are taken against the
    *global* fair share ``Pi_c / Pi * (W + work)`` — a reachable cluster
    already above its share is not a target even if it is locally the
    emptiest. Returns -1 when no reachable cluster can absorb work.
    """
    loads = np.asarray(loads, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    reachable = np.asarray(reachable, dtype=bool)
    usable = reachable & (powers > 0)
    if not usable.any():
        return -1
    fair = powers / max(powers.sum(), _TINY) * (loads.sum() + work)
    deficit = np.where(usable, np.maximum(fair - loads, 0.0), 0.0)
    ds = deficit.sum()
    if ds > _TINY:
        lam = exclusive_scan_np(deficit / ds)
        dst = int(owner_of_fraction(lam, np.array([0.5]))[0])
        if deficit[dst] + _TINY >= work:
            return dst
        # the positional owner cannot absorb this task inside its fair-
        # share deficit; fall through to the deepest reachable deficit,
        # and only when even that would overshoot does the task stay
        dst = int(np.argmax(deficit))
        return dst if deficit[dst] + _TINY >= work else -1
    # no reachable deficit: fall back to the least normalised load, the same
    # fallback the in-cluster positional rule uses when the grid is full
    ratio = np.where(usable, loads / np.maximum(powers, _TINY), np.inf)
    dst = int(np.argmin(ratio))
    return dst if np.isfinite(ratio[dst]) else -1


def choose_victim(loads: np.ndarray, powers: np.ndarray,
                  reachable: np.ndarray) -> int:
    """Pick the member an underloaded thief steals from — the pull-side
    dual of :func:`choose_destination`.

    Among the clusters reachable over an inbound link, the one with the
    largest surplus above its *global* fair share ``Pi_c / Pi * W`` wins;
    -1 when no reachable cluster is overloaded (nothing worth pulling).
    """
    loads = np.asarray(loads, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    reachable = np.asarray(reachable, dtype=bool)
    usable = reachable & (powers > 0)
    # a powered-down member is still worth robbing: its work is stranded
    usable |= reachable & (loads > _TINY)
    if not usable.any():
        return -1
    fair = powers / max(powers.sum(), _TINY) * loads.sum()
    surplus = np.where(usable, loads - fair, -np.inf)
    victim = int(np.argmax(surplus))
    return victim if surplus[victim] > _TINY else -1


def admit(load_src: float, power_src: float, load_dst: float,
          power_dst: float, work: float, delay: float,
          margin: float) -> bool:
    """Reservation-style admission for one WAN transfer.

    Predicted completion if the task stays is the source drain time; if it
    moves, the destination drain time (with the task's work added) plus the
    link delay. Admit only when moving wins by more than ``margin`` time
    units — the federation-level analogue of the crossover trigger's
    "rebalance only when the gain clears the overhead" rule.
    """
    if power_src <= 0:
        return power_dst > 0  # stranded work: any powered cluster wins
    if power_dst <= 0:
        return False
    t_stay = load_src / power_src
    t_move = (load_dst + work) / power_dst + delay
    return t_stay - t_move > margin


@dataclass
class ExchangeStats:
    """Accumulated WAN accounting for one federated run."""

    epochs: int = 0
    migrations: int = 0
    moved_units: float = 0.0
    moved_packets: float = 0.0
    rejected: int = 0  # admission-check refusals
    steals: int = 0  # migrations initiated by the pull side
    evictions_retargeted: int = 0  # eviction rows that followed a hand-off
    evictions_dropped: int = 0  # rows overtaken by the WAN transfer itself

    def to_dict(self) -> dict:
        return {
            "epochs": self.epochs,
            "migrations": self.migrations,
            "moved_units": self.moved_units,
            "moved_packets": self.moved_packets,
            "rejected": self.rejected,
            "steals": self.steals,
            "evictions_retargeted": self.evictions_retargeted,
            "evictions_dropped": self.evictions_dropped,
        }
