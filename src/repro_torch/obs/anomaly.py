"""Online anomaly detection over the probe series (EWMA + MAD).

The paper's trigger is *reactive*: it fires once imbalance has crossed
``max(crossover, floor)``. An operator wants the leading indicators —
queues growing faster than the cluster drains them, imbalance drifting
up toward the bound, the trigger firing in storms — flagged while the
bound is still intact. :class:`AnomalyMonitor` rides the existing probe
chain (one ``observe`` per PROBE_SAMPLE event, one ``observe_trigger``
per trigger evaluation) and keeps three detectors:

* ``queue_growth`` — robust z-score of the EWMA-smoothed queue-depth
  slope against the MAD of recent slope samples (floored at
  ``min_scale`` so the quantized deltas of a near-idle queue cannot
  zero the denominator). A sustained ramp gives a near-constant
  positive slope (tiny MAD, large z) and trips quickly; a balanced
  run's slope hovers around zero and never does.
* ``imbalance_drift`` — cluster imbalance ``I``, EWMA-smoothed, rising
  *toward* the trigger bound: within ``drift_margin`` of the newest
  :class:`CriticalPointMonitor` bound but still below it, while the
  newest evaluation was a skip. Above the bound the reactive trigger
  itself is the signal (and ``trigger_storm`` covers over-firing), so
  the detector stays quiet there — it flags exactly the window where
  imbalance is climbing but nothing has reacted yet.
* ``trigger_storm`` — more than ``storm_count`` fires inside a sliding
  ``storm_window`` of simulated time: the thrashing signature the
  paper's hysteresis floor exists to prevent.

Detection is deliberately scale-free: MAD (median absolute deviation
over a bounded window, the robust sibling of the standard deviation)
sets the noise scale, so thresholds transfer across workloads without
per-scenario tuning. Each detector re-arms only after ``cooldown``
samples, so a persistent condition raises one alert per episode, not one
per probe tick. Alerts are plain dicts; the engine forwards each through
the decision sink (``sink.alert(t, record)``) and ``export_obs``
surfaces the full list as ``extras["obs"]["alerts"]``.
"""

from __future__ import annotations

import math
from collections import deque
from statistics import median

__all__ = ["EwmaMad", "AnomalyMonitor"]

_EPS = 1e-9


class EwmaMad:
    """EWMA baseline + windowed-MAD scale over one scalar series.

    ``update(x)`` returns the robust z-score of the smoothed value: the
    EWMA of ``x`` against *the EWMA's own* standard error — per-sample
    sigma estimated as 1.4826x the median absolute deviation of the last
    ``window`` raw samples (the consistency constant that makes MAD
    estimate a Gaussian sigma; MAD is deviation from the window median,
    so a persistent shift inflates the center, not the scale), shrunk by
    the EWMA control-chart factor ``sqrt(alpha / (2 - alpha))`` — an
    exponentially-weighted mean of white noise is that much tighter than
    one sample. The denominator is floored at ``min_scale``: an
    integer-valued series sitting still has MAD 0, and without the floor
    any nonzero EWMA would score as an infinite-sigma event. During
    ``warmup`` the score is 0.
    """

    def __init__(self, *, alpha: float = 0.25, window: int = 64,
                 warmup: int = 8, min_scale: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {warmup}")
        if min_scale < 0:
            raise ValueError(f"min_scale must be >= 0, got {min_scale}")
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.min_scale = float(min_scale)
        self._ewma_factor = math.sqrt(self.alpha / (2.0 - self.alpha))
        self._recent: deque[float] = deque(maxlen=int(window))
        self.ewma: float | None = None
        self.n = 0

    def mad(self) -> float:
        """Median absolute deviation of the raw sample window."""
        if len(self._recent) < 2:
            return 0.0
        xs = list(self._recent)
        med = median(xs)
        return median(abs(x - med) for x in xs)

    def update(self, x: float) -> float:
        x = float(x)
        if not math.isfinite(x):
            return 0.0  # stranded-work inf: not this detector's signal
        self._recent.append(x)
        self.ewma = x if self.ewma is None \
            else self.ewma + self.alpha * (x - self.ewma)
        self.n += 1
        if self.n < self.warmup:
            return 0.0
        scale = 1.4826 * self.mad() * self._ewma_factor
        return self.ewma / max(scale, self.min_scale, _EPS)


class AnomalyMonitor:
    """Three EWMA+MAD detectors over the live probe/trigger chains."""

    def __init__(self, *, k: float = 6.0, alpha: float = 0.25,
                 window: int = 64, warmup: int = 8, min_scale: float = 0.5,
                 drift_margin: float = 0.8, storm_window: float = 20.0,
                 storm_count: int = 8, cooldown: int = 25,
                 monitor=None):
        if k <= 0:
            raise ValueError(f"k must be > 0, got {k}")
        if not 0.0 < drift_margin <= 1.0:
            raise ValueError(
                f"drift_margin must be in (0, 1], got {drift_margin}")
        self.k = float(k)
        self.drift_margin = float(drift_margin)
        self.storm_window = float(storm_window)
        self.storm_count = int(storm_count)
        self.cooldown = int(cooldown)
        self.monitor = monitor  # CriticalPointMonitor (bound source)
        self.alerts: list[dict] = []
        self._slope = EwmaMad(alpha=alpha, window=window, warmup=warmup,
                              min_scale=min_scale)
        self._imb = EwmaMad(alpha=alpha, window=window, warmup=warmup,
                            min_scale=min_scale)
        self._last_queue: float | None = None
        self._last_imb_ewma: float | None = None
        self._fires: deque[float] = deque()
        self._quiet = {"queue_growth": 0, "imbalance_drift": 0,
                       "trigger_storm": 0}

    # -- helpers -------------------------------------------------------
    def _raise(self, kind: str, t: float, **detail) -> dict | None:
        if self._quiet[kind] > 0:
            return None
        self._quiet[kind] = self.cooldown
        rec = {"t": float(t), "kind": kind, **detail}
        self.alerts.append(rec)
        return rec

    def _bound(self) -> float | None:
        """Newest known trigger bound ``max(crossover, floor)``, or
        ``None`` while the newest evaluation fired (reactive control is
        live — drift detection only applies while the trigger holds) or
        before the first evaluation (no bound learned yet)."""
        mon = self.monitor
        if mon is None or not mon.events:
            return None
        ev = mon.events[-1]
        return None if ev["fired"] else float(ev["bound"])

    # -- probe-chain hook ----------------------------------------------
    def observe(self, runtime, t: float) -> list[dict]:
        """One detection pass, right after the probe sampled; returns the
        alerts (possibly empty) this sample raised."""
        out = []
        # each detector's cooldown ticks on its own chain: probe samples
        # here, trigger evaluations in observe_trigger
        for kind in ("queue_growth", "imbalance_drift"):
            if self._quiet[kind] > 0:
                self._quiet[kind] -= 1
        probe = runtime._probe
        # queue-growth slope: per-sample delta of total queue population
        # (queued + blocked + in flight covers every waiting task)
        q = float(probe.queued_tasks[-1] + probe.blocked_tasks[-1]
                  + probe.in_flight[-1])
        if self._last_queue is not None:
            z = self._slope.update(q - self._last_queue)
            if z > self.k:
                rec = self._raise(
                    "queue_growth", t, score=z, threshold=self.k,
                    slope=self._slope.ewma, queue=q)
                if rec:
                    out.append(rec)
        self._last_queue = q
        # imbalance drift: smoothed cluster I rising into the margin
        # below the critical bound (and not yet past it)
        from ..core.trigger import imbalance
        i_now = imbalance(probe.node_load[-1], runtime.grid.powers)
        prev = self._imb.ewma
        self._imb.update(i_now if math.isfinite(i_now) else 0.0)
        bound = self._bound()
        if (bound is not None and bound > 0
                and self._imb.n >= self._imb.warmup
                and prev is not None and self._imb.ewma > prev
                and self.drift_margin * bound <= self._imb.ewma < bound):
            rec = self._raise(
                "imbalance_drift", t, imbalance=self._imb.ewma,
                bound=bound, margin=self.drift_margin)
            if rec:
                out.append(rec)
        return out

    # -- trigger-chain hook --------------------------------------------
    def observe_trigger(self, t: float, fired: bool) -> list[dict]:
        if self._quiet["trigger_storm"] > 0:
            self._quiet["trigger_storm"] -= 1
        if not fired:
            return []
        self._fires.append(float(t))
        while self._fires and self._fires[0] < t - self.storm_window:
            self._fires.popleft()
        if len(self._fires) > self.storm_count:
            rec = self._raise(
                "trigger_storm", t, fires=len(self._fires),
                window=self.storm_window, threshold=self.storm_count)
            return [rec] if rec else []
        return []

    # -- export --------------------------------------------------------
    def to_dict(self) -> list[dict]:
        """JSON-safe alert list (non-finite floats -> None)."""
        def _clean(rec):
            return {key: (None if isinstance(v, float)
                          and not math.isfinite(v) else v)
                    for key, v in rec.items()}
        return [_clean(rec) for rec in self.alerts]
