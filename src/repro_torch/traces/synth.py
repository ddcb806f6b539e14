"""``trace_scale`` — bootstrap an Nx-rate workload from a real trace.

One downloaded trace should yield arbitrarily many scenarios. The
synthesizer rescales the *rate* while preserving what makes the trace a
trace and not a Poisson process:

* **burstiness** — the time axis is cut into windows; each window's new
  arrival count is ``Poisson(factor x old count)``, so the rate *profile*
  (bursts, lulls, diurnal waves) is preserved at every window scale while
  counts stay integer and independent across windows;
* **priority / work / packet mix** — new tasks are resampled *jointly*
  (with replacement) from the same window's tasks, so within-window
  correlations between priority, size and payload survive; a task's
  placement constraints, eviction schedule (times shifted with its
  arrival) and end-of-life outcome travel with it;
* **arrival micro-structure** — resampled tasks keep their source arrival
  time plus uniform jitter of one mean inter-arrival gap, so sub-window
  clumping neither collapses onto duplicated timestamps nor smears into
  uniformity.

Determinism: the ``seed`` fully determines the output, and
``lab.WorkloadSpec(trace=TraceRef(..., scale=N))`` feeds the *scenario*
seed in — a seed sweep over a scaled trace is a real ensemble, unlike the
degenerate sweep over a raw trace replay.
"""

from __future__ import annotations

import numpy as np

from .schema import TraceSchema

__all__ = ["trace_scale"]


def trace_scale(trace: TraceSchema, factor: float, *, seed: int = 0,
                n_windows: int = 100) -> TraceSchema:
    """A new :class:`TraceSchema` whose arrival rate is ``factor`` times the
    source's, preserving the source's burst profile and per-window task
    mix. ``factor`` may be below 1 (thinning) or above (densification)."""
    if factor <= 0:
        raise ValueError(f"scale factor must be > 0, got {factor}")
    if n_windows < 1:
        raise ValueError(f"need at least one window, got {n_windows}")
    if trace.has_dag:
        raise ValueError(
            "trace_scale cannot resample a DAG trace: independent "
            "with-replacement task resampling has no meaningful edge "
            "semantics (a duplicated parent would gate which child?). "
            "Scale the underlying trace before attaching dependencies, or "
            "generate a synthetic DAG via WorkloadSpec(dag={...}).")
    m = trace.m
    if m == 0:
        return trace
    rng = np.random.default_rng(seed)
    t = trace.t_arrive
    span = float(t[-1] - t[0])
    if span <= 0:  # all arrivals at one instant: scale the count only
        count = rng.poisson(factor * m)
        src = rng.integers(0, m, size=count)
        order = np.argsort(src, kind="stable")  # deterministic tid order
        src = src[order]
        return TraceSchema(
            t_arrive=np.full(count, float(t[0])), works=trace.works[src],
            packets=trace.packets[src], priority=trace.priority[src],
            constraints=trace.constraints.select(src),
            evictions=trace.evictions.select(src),
            ends_evicted=trace.ends_evicted[src],
            t_zero_raw=trace.t_zero_raw)

    width = span / n_windows
    win = np.minimum(((t - t[0]) / width).astype(np.int64), n_windows - 1)
    counts = np.bincount(win, minlength=n_windows)
    new_counts = rng.poisson(factor * counts)
    jitter_scale = span / m  # one mean inter-arrival gap

    src_chunks: list[np.ndarray] = []
    time_chunks: list[np.ndarray] = []
    # windows with source tasks but a zero draw contribute nothing;
    # windows with no source tasks had zero rate and stay empty
    starts = np.searchsorted(win, np.arange(n_windows), side="left")
    stops = np.searchsorted(win, np.arange(n_windows), side="right")
    for w in np.flatnonzero((new_counts > 0) & (counts > 0)):
        pool = np.arange(starts[w], stops[w])
        src = rng.choice(pool, size=int(new_counts[w]), replace=True)
        times = t[src] + rng.uniform(0.0, jitter_scale, size=src.shape[0])
        src_chunks.append(src)
        time_chunks.append(times)
    if not src_chunks:
        return TraceSchema(t_arrive=np.zeros(0), works=np.zeros(0),
                           packets=np.zeros(0))
    src = np.concatenate(src_chunks)
    times = np.concatenate(time_chunks)
    order = np.argsort(times, kind="stable")
    src = src[order]
    new_t = times[order] - times.min()
    # a resampled task drags its eviction schedule along with its arrival
    evictions = trace.evictions.select(src).shifted(new_t - t[src])
    return TraceSchema(
        t_arrive=new_t, works=trace.works[src],
        packets=trace.packets[src], priority=trace.priority[src],
        constraints=trace.constraints.select(src),
        evictions=evictions, ends_evicted=trace.ends_evicted[src],
        t_zero_raw=trace.t_zero_raw)
