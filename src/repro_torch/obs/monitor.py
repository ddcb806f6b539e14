"""Critical-point trigger monitor (paper section 5, Tables 6-7).

The paper's operational result is a *bound*: rebalancing should fire when
observed imbalance ``I`` exceeds ``max(crossover, floor)`` where
``crossover = overhead / (W / Pi)``. The runtime already makes that
decision inside ``CrossoverTrigger``; this monitor keeps the structured
record of every evaluation — trigger or skip — so benchmarks can show
*when* PSTS fires against the live imbalance signal, and tests can check
each fire actually cleared the bound.
"""

from __future__ import annotations

import math

__all__ = ["CriticalPointMonitor"]


class CriticalPointMonitor:
    """Accumulates trigger evaluations as structured events."""

    def __init__(self, floor: float = 0.0):
        self.floor = float(floor)
        self.events: list[dict] = []

    def __len__(self) -> int:
        return len(self.events)

    def record(self, t: float, decision, *, floor: float | None = None,
               moved_packets: float = 0.0) -> dict:
        """Append one evaluation. ``decision`` is a ``TriggerDecision``
        (duck-typed: trigger / imbalance / crossover / overhead / gain)."""
        f = self.floor if floor is None else float(floor)
        ev = {
            "t": float(t),
            "fired": bool(decision.trigger),
            "imbalance": float(decision.imbalance),
            "crossover": float(decision.crossover),
            "floor": f,
            "bound": max(float(decision.crossover), f),
            "overhead": float(decision.overhead),
            "gain": float(decision.gain),
            "moved_packets": float(moved_packets),
        }
        self.events.append(ev)
        return ev

    # -- views ----------------------------------------------------------
    def fires(self) -> list[dict]:
        return [e for e in self.events if e["fired"]]

    def skips(self) -> list[dict]:
        return [e for e in self.events if not e["fired"]]

    def aligned(self) -> bool:
        """True iff every fire exceeded its bound and every skip did not —
        i.e. the online decisions agree with the paper's critical-point
        criterion ``I > max(crossover, floor)``."""
        for e in self.events:
            above = e["imbalance"] > e["bound"]
            if e["fired"] != above:
                return False
        return True

    def summary(self) -> dict:
        fires = self.fires()
        margins = [e["imbalance"] - e["bound"] for e in fires
                   if math.isfinite(e["imbalance"])]
        return {
            "n_evals": len(self.events),
            "n_fires": len(fires),
            "n_skips": len(self.events) - len(fires),
            "aligned": self.aligned(),
            "mean_fire_margin": (sum(margins) / len(margins)) if margins
            else None,
        }

    def to_dict(self) -> dict:
        """JSON-safe export (inf imbalance -> None, as in ProbeSeries)."""
        def _clean(ev):
            return {k: (None if isinstance(v, float) and not math.isfinite(v)
                        else v)
                    for k, v in ev.items()}
        return {"events": [_clean(e) for e in self.events],
                "summary": _clean(self.summary())}
