"""Google cluster-data task-events parser (clusterdata-2011 "v2" layout).

Column -> field semantics (task_events table, one row per event)::

    col  name                      used as
    ---  ------------------------  -------------------------------------
      0  timestamp (microseconds)  arrival / service-interval endpoints
      2  job ID                    half of the (job, task) join key
      3  task index                other half of the join key
      5  event type                0 SUBMIT / 1 SCHEDULE / 2 EVICT /
                                   3 FAIL / 4 FINISH / 5 KILL / 6 LOST
      8  priority                  bigger = more important; remapped to
                                   dense tiers with tier 0 = top
      9  CPU request (cores)       work-rate factor
     10  memory request            packets (migration payload size)

The mapping onto :class:`~repro_torch.traces.schema.TraceSchema`:

* ``t_arrive`` — first SUBMIT timestamp per (job, task), re-zeroed to the
  trace start and scaled by ``time_scale`` (default 1e-6: microseconds to
  seconds).
* ``works``   — service demand in core-seconds. ``eviction_mode`` picks the
  interval semantics:

  - ``"requeue"`` (default) — the *useful* demand: (final FINISH - last
    SCHEDULE) x CPU request, because every earlier EVICT/KILL/FAIL row
    becomes an exogenous requeue event in ``TraceSchema.evictions`` and
    the replay engine re-delivers the wasted attempts itself. Tasks whose
    final terminal is not a FINISH are flagged ``ends_evicted`` (their
    resubmission lies beyond the excerpt) and fall back to
    ``default_duration``.
  - ``"end"`` — the backward-compatible behavior: (last terminal
    event - first SCHEDULE) x CPU request, EVICT/KILL/FAIL simply ending
    the service interval. No requeue events are emitted, but
    ``ends_evicted`` still marks eviction-truncated tasks so replays can
    count them apart from completions instead of inflating throughput.

  In both modes, tasks with no usable interval fall back to
  ``default_duration`` (default: the median observed duration).
* ``packets`` — memory request x ``packet_scale`` (memory is the state a
  migration must move).
* ``priority``/``constraints`` — see above; constraints come from the
  companion task_constraints table (``constraints_path``) with columns
  ``timestamp, job ID, task index, operator, attribute name, value``
  and Google's operator codes 0 ``==`` / 1 ``!=`` / 2 ``<`` / 3 ``>``.
  Non-numeric attribute values (opaque hashes in the public trace) are
  kept for equality operators via :func:`repro_torch.traces.hash_attr_value`
  (a stable 48-bit code — declare node attributes through the same codec,
  e.g. ``ClusterSpec(attrs={"platform": ("P1", "P2", ...)})``, and the
  predicates match exactly); ordered comparisons on non-numeric values
  are undefined and dropped with a warning.

Rows may appear in any order (the public trace shards interleave); all
joins are grouped/vectorized, so ingest is O(rows log rows) NumPy work.
The Google v3 (2019) instance_events table projects onto the same columns
(timestamp, collection ID, instance index, type, priority, resource
request) — project it to this layout to reuse the parser.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..graphs import DagSpec
from .io import iter_numeric_chunks, iter_text_chunks
from .schema import (
    OPS,
    Constraints,
    Evictions,
    TraceSchema,
    dense_tiers,
    hash_attr_value,
)

__all__ = ["load_google_task_events", "GOOGLE_EVENT_TYPES",
           "EVICTION_MODES"]

# EVICT/KILL/FAIL handling: "requeue" replays them as preemption events,
# "end" keeps the older truncate-the-interval behavior
EVICTION_MODES = ("requeue", "end")

GOOGLE_EVENT_TYPES = {
    "SUBMIT": 0, "SCHEDULE": 1, "EVICT": 2, "FAIL": 3, "FINISH": 4,
    "KILL": 5, "LOST": 6,
}
_TERMINAL = (2, 3, 4, 5, 6)
# mid-life rows replayed as requeue events in eviction_mode="requeue"
_REQUEUE_TYPES = (2, 3, 5)  # EVICT, FAIL, KILL
_GOOGLE_OPS = {0: OPS["=="], 1: OPS["!="], 2: OPS["<"], 3: OPS[">"]}

# task_events columns we read (see module docstring)
_USECOLS = (0, 2, 3, 5, 8, 9, 10)
_T, _JOB, _TIDX, _EV, _PRI, _CPU, _MEM = range(len(_USECOLS))


def _pack_keys(job: np.ndarray, tidx: np.ndarray) -> np.ndarray:
    """(job, task index) -> one int64 key. Packing must be identical across
    the events and constraints files (the join compares raw keys), so ids
    too large to pack losslessly are a loud error, not a local re-encode."""
    job = job.astype(np.int64)
    tidx = tidx.astype(np.int64)
    if job.size == 0:
        return job
    if job.min() < 0 or tidx.min() < 0 or job.max() >= (1 << 42) \
            or tidx.max() >= (1 << 21):
        raise ValueError("job ID / task index outside the packable range "
                         "(job < 2^42, index < 2^21); renumber the trace "
                         "in a preprocessing pass")
    return (job << 21) | tidx


def _first_by_group(inv: np.ndarray, n: int, values: np.ndarray,
                    order_key: np.ndarray) -> np.ndarray:
    """Per group, the value at the smallest ``order_key`` (NaN where the
    group has no rows)."""
    out = np.full(n, np.nan)
    order = np.lexsort((order_key, inv))
    g = inv[order]
    first = np.ones(g.shape[0], dtype=bool)
    first[1:] = g[1:] != g[:-1]
    out[g[first]] = values[order][first]
    return out


def load_google_task_events(path, *, constraints_path=None,
                            eviction_mode: str = "requeue",
                            job_chains: bool = False,
                            time_scale: float = 1e-6,
                            packet_scale: float = 64.0,
                            default_duration: float | None = None,
                            horizon: float | None = None,
                            chunk_bytes: int = 1 << 24) -> TraceSchema:
    """Parse a task_events file (plain or gzipped CSV) into a
    :class:`TraceSchema`; see the module docstring for column semantics
    and the ``eviction_mode`` contract.

    ``job_chains=True`` synthesizes dependency edges from the job
    structure: within each job, tasks are chained in arrival order (task
    i+1 depends on task i) with each task's output size set to its
    ``packets`` (memory footprint = the state a child would fetch). The
    public trace records no real dataflow, so this is an explicitly
    synthetic DAG — off by default — but job-mates do ship together and
    chaining them recovers the pipeline shape batch jobs actually have.
    """
    if eviction_mode not in EVICTION_MODES:
        raise ValueError(f"unknown eviction_mode {eviction_mode!r}; "
                         f"have {sorted(EVICTION_MODES)}")
    chunks = list(iter_numeric_chunks(path, usecols=_USECOLS,
                                      chunk_bytes=chunk_bytes))
    if not chunks:
        return TraceSchema(t_arrive=np.zeros(0), works=np.zeros(0),
                           packets=np.zeros(0))
    rows = np.concatenate(chunks, axis=0)
    ev = rows[:, _EV].astype(np.int64)
    keys = _pack_keys(rows[:, _JOB], rows[:, _TIDX])
    uniq_keys, inv = np.unique(keys, return_inverse=True)

    sub = ev == GOOGLE_EVENT_TYPES["SUBMIT"]
    if not sub.any():
        raise ValueError(f"google trace {path!r}: no SUBMIT rows")
    n_all = uniq_keys.shape[0]
    big = np.float64(np.inf)
    ts = rows[:, _T]

    def grouped_min(mask, values):
        out = np.full(n_all, big)
        np.minimum.at(out, inv[mask], values[mask])
        return out

    sched = ev == GOOGLE_EVENT_TYPES["SCHEDULE"]
    t_submit = grouped_min(sub, ts)
    t_sched = grouped_min(sched, ts)
    t_last_sched = np.full(n_all, -big)
    np.maximum.at(t_last_sched, inv[sched], ts[sched])
    term = np.isin(ev, _TERMINAL)
    t_end = np.full(n_all, -big)
    np.maximum.at(t_end, inv[term], ts[term])
    # final terminal event type per task (FINISH wins a timestamp tie —
    # the kindest reading of an ambiguous shard interleave)
    tr_idx = np.flatnonzero(term)
    final_type = np.full(n_all, -1, dtype=np.int64)
    if tr_idx.size:
        fin = (ev[tr_idx] == GOOGLE_EVENT_TYPES["FINISH"]).astype(np.int8)
        o = np.lexsort((fin, ts[tr_idx], inv[tr_idx]))
        g = inv[tr_idx][o]
        last = np.ones(g.shape[0], dtype=bool)
        last[:-1] = g[1:] != g[:-1]
        final_type[g[last]] = ev[tr_idx][o][last]

    # per-task attributes from the earliest SUBMIT row
    pri = _first_by_group(inv[sub], n_all, rows[sub, _PRI], ts[sub])
    cpu = _first_by_group(inv[sub], n_all, rows[sub, _CPU], ts[sub])
    mem = _first_by_group(inv[sub], n_all, rows[sub, _MEM], ts[sub])

    seen = np.isfinite(t_submit) & (t_submit < big)
    idx = np.flatnonzero(seen)
    # kept-task position of each raw group (-1 = task never SUBMITted)
    pos = np.full(n_all, -1, dtype=np.int64)
    pos[idx] = np.arange(idx.size)
    t_end_full = t_end  # per-group, pre-filter (eviction rows index it)
    t_submit, t_sched, t_end = t_submit[idx], t_sched[idx], t_end[idx]
    t_last_sched, final_type = t_last_sched[idx], final_type[idx]
    pri, cpu, mem = pri[idx], cpu[idx], mem[idx]
    kept_keys = uniq_keys[idx]

    finished = final_type == GOOGLE_EVENT_TYPES["FINISH"]
    ends_evicted = (t_end > -big) & ~finished
    if eviction_mode == "end":
        dur = (t_end - t_sched) * time_scale
        have_dur = np.isfinite(t_sched) & (t_sched < big) & (t_end > -big) \
            & (dur > 0)
    else:
        # useful demand: the final successful run only — earlier attempts
        # are re-delivered by the replay engine via the eviction events
        dur = (t_end - t_last_sched) * time_scale
        have_dur = finished & (t_last_sched > -big) & (dur > 0)
    if default_duration is None:
        if have_dur.any():
            default_duration = float(np.median(dur[have_dur]))
        else:
            raise ValueError(
                f"google trace {path!r}: no complete SCHEDULE->end "
                f"interval and no default_duration given — cannot derive "
                f"service demands")
    dur = np.where(have_dur, dur, default_duration)
    n_fallback = int((~have_dur).sum())
    if n_fallback:
        warnings.warn(
            f"google trace {path!r}: {n_fallback} of {dur.shape[0]} tasks "
            f"have no complete service interval; using "
            f"default_duration={default_duration:g}", stacklevel=2)

    good_cpu = cpu[np.isfinite(cpu) & (cpu > 0)]
    cpu_fill = float(np.median(good_cpu)) if good_cpu.size else 1.0
    cpu = np.where(np.isfinite(cpu) & (cpu > 0), cpu, cpu_fill)
    mem = np.where(np.isfinite(mem) & (mem > 0), mem, 1.0 / packet_scale)
    pri = np.where(np.isfinite(pri), pri, 0.0)

    t_zero = t_submit.min()
    t_arrive = (t_submit - t_zero) * time_scale
    works = np.maximum(dur * cpu, 1e-9)
    packets = np.maximum(mem * packet_scale, 1e-9)
    tiers = dense_tiers(pri.astype(np.int64), higher_is_more_important=True)

    order = np.argsort(t_arrive, kind="stable")
    rank = np.empty(order.shape[0], dtype=np.int64)
    rank[order] = np.arange(order.shape[0])
    constraints = _load_constraints(constraints_path, kept_keys[order],
                                    chunk_bytes)
    evictions = Evictions()
    if eviction_mode == "requeue":
        # every EVICT/KILL/FAIL strictly before the task's final terminal
        # becomes a requeue event (the final one, if any, is the task's end
        # — recorded in ends_evicted, not replayed)
        req = np.isin(ev, _REQUEUE_TYPES) & (ts < t_end_full[inv])
        if req.any():
            r_task = pos[inv[req]]
            ok = r_task >= 0
            r_task = rank[r_task[ok]]
            r_time = (ts[req][ok] - t_zero) * time_scale
            o = np.lexsort((r_task, r_time))
            evictions = Evictions(r_task[o], r_time[o])
    dag = DagSpec()
    if job_chains:
        # chain each job's tasks in final arrival order: sort kept tasks by
        # (job, arrival rank) and link consecutive same-job pairs
        jobs = kept_keys >> 21
        o = np.lexsort((rank, jobs))
        same = jobs[o][1:] == jobs[o][:-1]
        dag = DagSpec(child=rank[o][1:][same], parent=rank[o][:-1][same],
                      out_size=packets[order], m=order.shape[0])
    trace = TraceSchema(t_arrive=t_arrive[order], works=works[order],
                        packets=packets[order], priority=tiers[order],
                        constraints=constraints, evictions=evictions,
                        ends_evicted=ends_evicted[order], dag=dag,
                        t_zero_raw=float(t_zero))
    if horizon is not None:
        trace = trace.clipped(horizon)
    return trace


def _load_constraints(path, task_keys: np.ndarray,
                      chunk_bytes: int) -> Constraints:
    """task_constraints join: rows land on the trace position of their
    (job, task index) key. Non-numeric attribute values are encoded with
    ``hash_attr_value`` when the operator is ``==``/``!=``; rows for tasks
    outside the events file, or with non-numeric values under an ordered
    operator, are dropped (counted in a warning)."""
    if path is None:
        return Constraints()
    names: list[str] = []
    name_idx: dict[str, int] = {}
    t_job, t_tidx, t_op, t_attr, t_val = [], [], [], [], []
    dropped = 0
    for text in iter_text_chunks(path, chunk_bytes=chunk_bytes):
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) < 6:
                dropped += 1
                continue
            _, job, tidx, op, attr, value = parts[:6]
            try:
                op_code = _GOOGLE_OPS[int(float(op))]
            except (KeyError, ValueError):
                dropped += 1
                continue
            try:
                val = float(value)
            except ValueError:
                # opaque categorical value (the public trace ships them as
                # base64-ish hashes): meaningful under ==/!= only, where a
                # stable hash code preserves the predicate exactly; ordered
                # comparisons on them are undefined and stay dropped
                if op_code in (OPS["=="], OPS["!="]):
                    val = hash_attr_value(value.strip())
                else:
                    dropped += 1
                    continue
            try:
                t_job.append(int(float(job)))
                t_tidx.append(int(float(tidx)))
            except ValueError:
                dropped += 1
                continue
            attr = attr.strip()
            if attr not in name_idx:
                name_idx[attr] = len(names)
                names.append(attr)
            t_op.append(op_code)
            t_attr.append(name_idx[attr])
            t_val.append(val)
    if dropped:
        warnings.warn(f"task_constraints {path!r}: dropped {dropped} "
                      f"row(s) (malformed, unknown operator, or "
                      f"non-numeric attribute value under an ordered "
                      f"operator)", stacklevel=3)
    if not t_job:
        return Constraints()
    keys = _pack_keys(np.asarray(t_job), np.asarray(t_tidx))
    # map constraint keys onto trace positions (task_keys is in final
    # arrival order); unmatched keys are dropped
    order = np.argsort(task_keys, kind="stable")
    sorted_keys = task_keys[order]
    pos = np.searchsorted(sorted_keys, keys)
    pos = np.clip(pos, 0, sorted_keys.shape[0] - 1)
    matched = sorted_keys[pos] == keys
    if not matched.all():
        warnings.warn(f"task_constraints {path!r}: "
                      f"{int((~matched).sum())} row(s) reference tasks "
                      f"absent from the events file", stacklevel=3)
    task_pos = order[pos[matched]]
    return Constraints(
        tuple(names), task_pos,
        np.asarray(t_attr, dtype=np.int32)[matched],
        np.asarray(t_op, dtype=np.int8)[matched],
        np.asarray(t_val, dtype=np.float64)[matched])
