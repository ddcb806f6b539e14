"""Workload generators: staggered arrival processes over the paper's work
distributions.

The paper staggers 4000 tasks over time with work units and packet counts
drawn from uniform / Poisson distributions (section 5); this module keeps
those marginals and adds the arrival processes a production cluster sees:

* ``poisson``  — memoryless arrivals at a constant rate,
* ``bursty``   — a 2-state Markov-modulated Poisson process (MMPP-2):
                 exponential sojourns alternate a low and a high rate,
* ``diurnal``  — inhomogeneous Poisson with a sinusoidal rate (thinning),
* ``trace``    — replay of explicit arrival timestamps.

``to_slots``/``batch_slots`` convert workloads to the fixed-shape tensors the
vectorized backend consumes (slot index per task, padded to a common task
count with zero-work sentinels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "Workload",
    "sample_works",
    "sample_packets",
    "poisson_arrivals",
    "bursty_arrivals",
    "diurnal_arrivals",
    "trace_arrivals",
    "ARRIVAL_PROCESSES",
    "make_workload",
    "load_trace_csv",
    "to_slots",
    "batch_slots",
]


@dataclass(frozen=True)
class Workload:
    """Tasks sorted by arrival time. ``works`` = beta_i (work units),
    ``packets`` = mu_i (migration transfer size)."""

    t_arrive: np.ndarray  # (m,) float64, nondecreasing
    works: np.ndarray     # (m,) float64, > 0
    packets: np.ndarray   # (m,) float64, > 0

    def __post_init__(self):
        t = np.asarray(self.t_arrive, dtype=np.float64)
        if t.size and (np.diff(t) < 0).any():
            raise ValueError("arrival times must be sorted")
        object.__setattr__(self, "t_arrive", t)
        object.__setattr__(self, "works",
                           np.asarray(self.works, dtype=np.float64))
        object.__setattr__(self, "packets",
                           np.asarray(self.packets, dtype=np.float64))

    @property
    def m(self) -> int:
        return int(self.t_arrive.shape[0])

    @property
    def horizon(self) -> float:
        return float(self.t_arrive[-1]) if self.m else 0.0


def sample_works(m: int, dist: str, mean: float,
                 rng: np.random.Generator) -> np.ndarray:
    """The paper's two work-unit distributions (section 5)."""
    if dist == "uniform":
        return rng.uniform(1.0, 2.0 * mean - 1.0, size=m)
    if dist == "poisson":
        return 1.0 + rng.poisson(mean - 1.0, size=m).astype(np.float64)
    raise ValueError(f"unknown work distribution {dist!r}")


def sample_packets(m: int, mean: float,
                   rng: np.random.Generator) -> np.ndarray:
    return 1.0 + rng.poisson(mean, size=m).astype(np.float64)


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

def poisson_arrivals(horizon: float, rng: np.random.Generator, *,
                     rate: float = 1.0) -> np.ndarray:
    """Homogeneous Poisson process on [0, horizon)."""
    m = rng.poisson(rate * horizon)
    return np.sort(rng.uniform(0.0, horizon, size=m))


def bursty_arrivals(horizon: float, rng: np.random.Generator, *,
                    rate_lo: float = 0.2, rate_hi: float = 5.0,
                    sojourn_lo: float = 20.0,
                    sojourn_hi: float = 4.0) -> np.ndarray:
    """MMPP-2: alternate exponential sojourns in a low-rate and a high-rate
    state; within each sojourn arrivals are Poisson at that state's rate."""
    times: list[np.ndarray] = []
    t, hi = 0.0, False
    while t < horizon:
        sojourn = rng.exponential(sojourn_hi if hi else sojourn_lo)
        end = min(t + sojourn, horizon)
        rate = rate_hi if hi else rate_lo
        k = rng.poisson(rate * (end - t))
        if k:
            times.append(rng.uniform(t, end, size=k))
        t, hi = end, not hi
    if not times:
        return np.zeros(0, dtype=np.float64)
    return np.sort(np.concatenate(times))


def diurnal_arrivals(horizon: float, rng: np.random.Generator, *,
                     rate_mean: float = 1.0, amplitude: float = 0.8,
                     period: float = 100.0) -> np.ndarray:
    """Inhomogeneous Poisson with rate ``mean * (1 + A sin(2 pi t / T))``,
    sampled by thinning against the peak rate."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError("amplitude must be in [0, 1]")
    peak = rate_mean * (1.0 + amplitude)
    cand = poisson_arrivals(horizon, rng, rate=peak)
    lam = rate_mean * (1.0 + amplitude * np.sin(2.0 * np.pi * cand / period))
    keep = rng.uniform(0.0, peak, size=cand.shape[0]) < lam
    return cand[keep]


def trace_arrivals(horizon: float, rng: np.random.Generator, *,
                   times=()) -> np.ndarray:
    """Replay explicit timestamps (clipped to the horizon)."""
    t = np.sort(np.asarray(list(times), dtype=np.float64))
    return t[t < horizon]


ARRIVAL_PROCESSES = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
    "diurnal": diurnal_arrivals,
    "trace": trace_arrivals,
}


def make_workload(process: str = "poisson", *, horizon: float = 100.0,
                  work_dist: str = "uniform", work_mean: float = 4.0,
                  packet_mean: float = 8.0, seed: int = 0,
                  **process_kwargs) -> Workload:
    """One scenario: arrival process x paper work/packet marginals."""
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {process!r}; "
                         f"have {sorted(ARRIVAL_PROCESSES)}")
    rng = np.random.default_rng(seed)
    t = ARRIVAL_PROCESSES[process](horizon, rng, **process_kwargs)
    m = t.shape[0]
    return Workload(
        t_arrive=t,
        works=sample_works(m, work_dist, work_mean, rng),
        packets=sample_packets(m, packet_mean, rng),
    )


def load_trace_csv(path, *, horizon: float | None = None) -> Workload:
    """Load a cluster trace from CSV rows of ``t_arrive, work, packets``.

    The minimal interchange format for real cluster traces (first step toward
    Google cluster-data / Azure Packing Trace replay): one task per row, ``#``
    comments and blank lines ignored, rows in any order (sorted by arrival
    here). ``horizon`` clips tasks arriving at or after it, matching the
    ``trace`` arrival process.
    """
    rows = np.loadtxt(path, delimiter=",", comments="#", ndmin=2,
                      dtype=np.float64)
    if rows.size == 0:
        rows = rows.reshape(0, 3)
    if rows.shape[1] != 3:
        raise ValueError(
            f"trace {path!r}: expected 3 columns (t_arrive, work, packets), "
            f"got {rows.shape[1]}")
    order = np.argsort(rows[:, 0], kind="stable")
    t, works, packets = rows[order].T
    if horizon is not None:
        keep = t < horizon
        t, works, packets = t[keep], works[keep], packets[keep]
    if (works <= 0).any() or (packets <= 0).any():
        raise ValueError(f"trace {path!r}: work and packets must be > 0")
    return Workload(t_arrive=t, works=works, packets=packets)


# ---------------------------------------------------------------------------
# Slotted views for the vectorized backend
# ---------------------------------------------------------------------------

def to_slots(wl: Workload, dt: float, n_slots: int,
             max_tasks: int | None = None):
    """Quantise a workload onto a slot grid.

    Returns ``(arrive_slot, works, count)`` where padding entries carry
    ``arrive_slot == n_slots`` (an out-of-range sentinel the backend drops)
    and zero work. Tasks at or beyond the horizon are truncated.
    """
    keep = wl.t_arrive < dt * n_slots
    slot = np.floor(wl.t_arrive[keep] / dt).astype(np.int32)
    works = wl.works[keep]
    count = int(slot.shape[0])
    cap = count if max_tasks is None else int(max_tasks)
    if count > cap:
        slot, works, count = slot[:cap], works[:cap], cap
    out_slot = np.full(cap, n_slots, dtype=np.int32)
    out_work = np.zeros(cap, dtype=np.float64)
    out_slot[:count] = slot
    out_work[:count] = works
    return out_slot, out_work, count


def batch_slots(workloads, dt: float, n_slots: int):
    """Stack scenarios into ``(B, M)`` tensors with a common task capacity."""
    cap = max((int((wl.t_arrive < dt * n_slots).sum()) for wl in workloads),
              default=0)
    slots, works, counts = [], [], []
    for wl in workloads:
        s, w, c = to_slots(wl, dt, n_slots, max_tasks=cap)
        slots.append(s)
        works.append(w)
        counts.append(c)
    return (np.stack(slots), np.stack(works),
            np.asarray(counts, dtype=np.int64))
