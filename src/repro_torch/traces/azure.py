"""Azure Packing Trace parser (AzurePackingTraceV1 layout).

The packing trace ships as two tables; both are consumed as (optionally
gzipped) CSV exports:

``vm`` table (the main file) — one row per VM request::

    col  name       used as
    ---  ---------  ----------------------------------------------
      0  vmId       task id (informational only)
      1  tenantId   (ignored)
      2  vmTypeId   join key into the vmType table
      3  priority   1 = high priority -> tier 0; 0 = spot -> tier 1
      4  starttime  arrival (fractional days, may be negative for
                    VMs alive before the trace window)
      5  endtime    departure (fractional days; empty = still alive
                    when the window closed)

``vmType`` table (``vmtypes_path``, optional) — per-type resources::

    col  name      used as
    ---  --------  ------------------------------------------------
      0  vmTypeId  join key
      1  core      work-rate factor AND placement constraint
                   (``cores >= core``: the VM only fits machines
                   declaring at least that many cores)
      2  memory    packets (migration payload size)

Mapping onto :class:`~repro_torch.traces.schema.TraceSchema`:

* ``t_arrive`` — ``(starttime - min(starttime)) * time_scale`` (default
  ``time_scale=24.0``: days to hours).
* ``works``   — lifetime x core count (core-hours by default). Open-ended
  VMs (no endtime) fall back to ``default_duration`` (default: median
  observed lifetime).
* ``packets`` — memory x ``packet_scale``.
* ``priority`` — Azure's two native classes map 1 -> tier 0, 0 -> tier 1;
  any other value warns and maps by relative order (bigger = more
  important), so experimental traces with extra classes still load.
* ``constraints`` — when ``vmtypes_path`` is given, every VM gets
  ``cores >= core(vmTypeId)`` — the packing-constraint dimension that
  makes this trace interesting for constrained balancing.
"""

from __future__ import annotations

import warnings

import numpy as np

from .io import read_numeric_csv
from .schema import OPS, Constraints, TraceSchema, dense_tiers

__all__ = ["load_azure_packing"]

_KNOWN_PRIORITIES = (0, 1)


def load_azure_packing(path, *, vmtypes_path=None, time_scale: float = 24.0,
                       packet_scale: float = 16.0,
                       default_duration: float | None = None,
                       horizon: float | None = None,
                       chunk_bytes: int = 1 << 24) -> TraceSchema:
    """Parse a packing-trace vm table (plus optional vmType table) into a
    :class:`TraceSchema`; see the module docstring for column semantics."""
    rows = read_numeric_csv(path, usecols=(2, 3, 4, 5),
                            chunk_bytes=chunk_bytes)
    if rows.shape[0] == 0:
        return TraceSchema(t_arrive=np.zeros(0), works=np.zeros(0),
                           packets=np.zeros(0))
    vmtype = rows[:, 0]
    pri_raw = rows[:, 1]
    start = rows[:, 2]
    end = rows[:, 3]
    if not np.isfinite(start).all():
        raise ValueError(f"azure trace {path!r}: starttime column has "
                         f"missing values")

    dur = (end - start) * time_scale
    have = np.isfinite(dur) & (dur > 0)
    if default_duration is None:
        if have.any():
            default_duration = float(np.median(dur[have]))
        else:
            raise ValueError(f"azure trace {path!r}: every VM is "
                             f"open-ended and no default_duration given")
    dur = np.where(have, dur, default_duration)
    n_open = int((~have).sum())
    if n_open:
        warnings.warn(f"azure trace {path!r}: {n_open} of {dur.shape[0]} "
                      f"VMs are open-ended; using "
                      f"default_duration={default_duration:g}",
                      stacklevel=2)

    core = np.ones(rows.shape[0])
    mem = np.ones(rows.shape[0])
    constraints = Constraints()
    if vmtypes_path is not None:
        types = read_numeric_csv(vmtypes_path, usecols=(0, 1, 2),
                                 chunk_bytes=chunk_bytes)
        want = vmtype.astype(np.int64)
        if types.shape[0] == 0:
            hit = np.zeros(want.shape[0], dtype=bool)
        else:
            type_ids = types[:, 0].astype(np.int64)
            order = np.argsort(type_ids, kind="stable")
            type_ids = type_ids[order]
            pos = np.clip(np.searchsorted(type_ids, want), 0,
                          type_ids.shape[0] - 1)
            hit = type_ids[pos] == want
            core = np.where(hit, types[order][pos, 1], 1.0)
            mem = np.where(hit, types[order][pos, 2], 1.0)
        if not hit.all():
            warnings.warn(
                f"azure trace {path!r}: {int((~hit).sum())} VM(s) "
                f"reference vmTypeIds absent from {vmtypes_path!r}; "
                f"assuming 1 core / 1 memory unit", stacklevel=2)

    raw_int = pri_raw.astype(np.int64)
    unknown = sorted(set(np.unique(raw_int).tolist())
                     - set(_KNOWN_PRIORITIES))
    if unknown:
        warnings.warn(
            f"azure trace {path!r}: unknown priority value(s) {unknown} "
            f"(expected {list(_KNOWN_PRIORITIES)}); mapping by relative "
            f"order (bigger = more important)", stacklevel=2)
    tiers = dense_tiers(raw_int, higher_is_more_important=True)

    t_arrive = (start - start.min()) * time_scale
    works = np.maximum(dur * np.maximum(core, 1e-9), 1e-9)
    packets = np.maximum(mem * packet_scale, 1e-9)

    order = np.argsort(t_arrive, kind="stable")
    if vmtypes_path is not None:
        m = rows.shape[0]
        constraints = Constraints(
            ("cores",), np.arange(m, dtype=np.int64),
            np.zeros(m, dtype=np.int32),
            np.full(m, OPS[">="], dtype=np.int8),
            np.maximum(core, 1e-9)).select(order)
    trace = TraceSchema(t_arrive=t_arrive[order], works=works[order],
                        packets=packets[order], priority=tiers[order],
                        constraints=constraints)
    if horizon is not None:
        trace = trace.clipped(horizon)
    return trace
