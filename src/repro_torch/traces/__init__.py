"""repro_torch.traces — real-trace ingestion: priorities and placement constraints.

The paper validates only on synthetic uniform/Poisson workloads; this
subsystem opens the real-workload axis. Three formats parse into one
normalized :class:`TraceSchema` (a :class:`repro_torch.runtime.Workload` plus
per-task priority tiers and node-attribute constraints):

* ``"google"`` — Google cluster-data v2 task_events (+ task_constraints),
* ``"azure"``  — Azure Packing Trace vm table (+ vmType join),
* ``"csv"``    — the repo's normalized CSV (+ JSON constraints sidecar).

All parsers stream in large chunks with NumPy-vectorized column handling
and transparent gzip, so million-row traces ingest in seconds. The
:func:`trace_scale` synthesizer bootstraps an Nx-rate workload from any
loaded trace while preserving its burstiness and priority mix.

Churn replays, too: the Google parser emits EVICT/KILL/FAIL rows as
exogenous requeue events (``eviction_mode="requeue"``, with ``"end"`` as
the backward-compatible truncation), and
:func:`load_google_machine_events` maps machine_events capacity churn onto
the engine's fault schedule (failure/join/resize).

Run one through the lab::

    from repro_torch import lab
    sc = lab.Scenario(
        cluster=lab.ClusterSpec(powers=(3, 1, 7, 2),
                                attrs={"machine_class": (0, 1, 2, 3)}),
        workload=lab.WorkloadSpec(
            trace=lab.TraceRef(path="events.csv.gz", format="google",
                               params={"constraints_path": "constr.csv"}),
            horizon=None),
    )
    lab.run(sc)  # events backend; extras carry per-priority-tier waits
"""

from __future__ import annotations

from .azure import load_azure_packing
from .google import (
    EVICTION_MODES,
    GOOGLE_EVENT_TYPES,
    load_google_task_events,
)
from .machines import (
    MACHINE_EVENT_TYPES,
    MachineSchedule,
    load_google_machine_events,
)
from ..graphs import DagSpec
from .normalized import load_normalized_csv, write_normalized_csv
from .schema import (
    OP_NAMES,
    OPS,
    Constraints,
    Evictions,
    InfeasibleTaskError,
    TraceSchema,
    dense_tiers,
    hash_attr_value,
)
from .synth import trace_scale

__all__ = [
    "OPS", "OP_NAMES", "Constraints", "DagSpec", "Evictions",
    "InfeasibleTaskError",
    "TraceSchema", "dense_tiers", "hash_attr_value",
    "EVICTION_MODES", "GOOGLE_EVENT_TYPES", "load_google_task_events",
    "MACHINE_EVENT_TYPES", "MachineSchedule", "load_google_machine_events",
    "load_azure_packing",
    "load_normalized_csv", "write_normalized_csv",
    "trace_scale",
    "TRACE_FORMATS", "load_trace",
]

# format name -> loader(path, **params); every loader accepts ``horizon``
# and returns a TraceSchema sorted by arrival
TRACE_FORMATS = {
    "csv": load_normalized_csv,
    "google": load_google_task_events,
    "azure": load_azure_packing,
}


def load_trace(path, *, format: str = "csv", params: dict | None = None,
               horizon: float | None = None, scale: float | None = None,
               seed: int = 0) -> TraceSchema:
    """One entry point over every format: parse, then optionally rescale.

    ``scale`` applies :func:`trace_scale` driven by ``seed`` — the hook
    ``lab.WorkloadSpec(trace=TraceRef(..., scale=N))`` uses to turn one
    trace file into a seed-swept scenario ensemble. ``horizon`` clips
    *after* scaling so the scaled replay covers the same window.
    """
    if format not in TRACE_FORMATS:
        raise ValueError(f"unknown trace format {format!r}; "
                         f"have {sorted(TRACE_FORMATS)}")
    trace = TRACE_FORMATS[format](path, **dict(params or {}))
    if scale is not None:
        trace = trace_scale(trace, float(scale), seed=seed)
    if horizon is not None:
        trace = trace.clipped(horizon)
    return trace
