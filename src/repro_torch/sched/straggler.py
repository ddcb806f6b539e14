"""Adaptive processing-power estimation (the paper's adaptive tau).

Hosts report per-step wall times; an EWMA turns them into relative powers
``tau_i`` consumed by data_balance / request_sched. Dead hosts (no
heartbeat) become the paper's *virtual nodes* (tau = 0), which makes PSTS
drain them — the elastic path."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["StragglerMonitor"]


@dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.3             # EWMA coefficient
    straggler_factor: float = 1.5  # step time above median * factor = straggler
    heartbeat_limit: int = 3       # missed updates before declared dead
    # optional repro_torch.obs.Tracer: records per-update wall latency
    tracer: object | None = None

    _ewma: np.ndarray = field(init=False)
    _missed: np.ndarray = field(init=False)

    def __post_init__(self):
        self._ewma = np.full(self.n_hosts, np.nan)
        self._missed = np.zeros(self.n_hosts, dtype=int)

    def update(self, step_times: dict[int, float] | np.ndarray) -> None:
        """step_times: per-host seconds for the last step; hosts missing
        from a dict report count as missed heartbeats."""
        t0 = time.perf_counter()
        if isinstance(step_times, dict):
            seen = np.zeros(self.n_hosts, bool)
            for h, t in step_times.items():
                seen[h] = True
                self._observe(h, t)
            self._missed[~seen] += 1
        else:
            times = np.asarray(step_times, dtype=np.float64)
            for h in range(self.n_hosts):
                self._observe(h, times[h])
        if self.tracer is not None:
            self.tracer.decision("estimate", time.perf_counter() - t0)

    def _observe(self, h: int, t: float) -> None:
        self._missed[h] = 0
        if np.isnan(self._ewma[h]):
            self._ewma[h] = t
        else:
            self._ewma[h] = (1 - self.alpha) * self._ewma[h] + self.alpha * t

    @property
    def alive(self) -> np.ndarray:
        return self._missed < self.heartbeat_limit

    def powers(self) -> np.ndarray:
        """Relative tau per host: inverse EWMA step time, normalised to mean
        1 over live hosts; dead hosts get 0 (virtual nodes)."""
        tau = np.zeros(self.n_hosts)
        live = self.alive & ~np.isnan(self._ewma)
        if not live.any():
            return np.ones(self.n_hosts)  # no data yet: assume uniform
        inv = 1.0 / self._ewma[live]
        tau[live] = inv / inv.mean()
        return tau

    def stragglers(self) -> np.ndarray:
        """Hosts whose step time exceeds factor * live median."""
        live = self.alive & ~np.isnan(self._ewma)
        out = np.zeros(self.n_hosts, bool)
        if live.sum() == 0:
            return out
        med = np.median(self._ewma[live])
        out[live] = self._ewma[live] > self.straggler_factor * med
        return out
