"""Telemetry subsystem: lifecycle tracing, live probes, trigger monitoring.

Three instruments, all zero-cost when absent (the runtime guards every
hook behind an ``is not None`` check and the batched backend compiles the
probe carry-outs away when the static flag is off):

- :class:`Tracer` — per-task lifecycle spans (submit -> dispatch -> start
  -> migrate/evict/resize -> complete) and per-decision scheduler latency,
  exported as Chrome-trace / Perfetto JSON, with a bounded-memory ring mode;
  the batched sweep engine's phases on the ``PID_ENGINE`` lane, on the
  profiler's wall clock.
- :class:`ProbeSeries` — sampled time-series: per-node occupancy, queue
  depth, per-tier queued work, and hyper-grid imbalance at every recursion
  level.
- :class:`CriticalPointMonitor` — evaluates the paper's trigger bound
  online against the sampled imbalance signal and keeps structured
  trigger/skip events.

The ops plane adds the scrapeable surface on top:

- :class:`MetricsRegistry` + :class:`RegistryCollector` — label-aware
  Counter/Gauge/Histogram families with O(1) updates, fed by the decision
  sink and refreshed from engine state at scrape time;
- ``to_openmetrics`` / ``parse_openmetrics`` — Prometheus/OpenMetrics
  text exposition and its strict round-trip parser (the CI lint);
- :class:`AnomalyMonitor` — EWMA+MAD detectors (queue growth, imbalance
  drift toward the critical bound, trigger storms) on the probe chain;
- ``merge_chrome_traces`` — stitched, clock-aligned federation traces
  (span ``trace_id``/``span_id``/``parent_id`` ride in event args).

``build_instruments`` / ``export_obs`` are the glue the lab's events
backend uses to turn an ``ObsSpec`` into live instruments and back into
``RunResult.extras["obs"]``.

The subsystem is host code (the standard library and numpy), carried over
from the JAX package's ``repro.obs``: the same run gives the same export,
apart from the wall-clock decision latencies.
"""

from .anomaly import AnomalyMonitor, EwmaMad
from .export import (
    MetricsHTTPServer,
    merge_chrome_traces,
    parse_openmetrics,
    to_openmetrics,
    write_metrics_jsonl,
)
from .monitor import CriticalPointMonitor
from .probe import ProbeSeries, imbalance_by_level
from .registry import (
    Counter,
    FanoutSink,
    Gauge,
    Histogram,
    MetricsRegistry,
    RegistryCollector,
    attach_collector,
    log_buckets,
    merge_registries,
)
from .tracer import (
    NULL_TRACER,
    PID_ENGINE,
    PID_NODES,
    PID_SCHED,
    PID_TASKS,
    NullTracer,
    Tracer,
)
from .wire import Instruments, build_instruments, export_obs

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "PID_NODES",
    "PID_TASKS",
    "PID_SCHED",
    "PID_ENGINE",
    "ProbeSeries",
    "imbalance_by_level",
    "CriticalPointMonitor",
    "Instruments",
    "build_instruments",
    "export_obs",
    "MetricsRegistry",
    "RegistryCollector",
    "FanoutSink",
    "attach_collector",
    "Counter",
    "Gauge",
    "Histogram",
    "log_buckets",
    "merge_registries",
    "to_openmetrics",
    "parse_openmetrics",
    "merge_chrome_traces",
    "MetricsHTTPServer",
    "write_metrics_jsonl",
    "AnomalyMonitor",
    "EwmaMad",
]
