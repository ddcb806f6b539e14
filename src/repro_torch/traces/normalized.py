"""The repo's own normalized trace format (CSV + optional JSON sidecar).

The interchange format every parser normalizes *to*, loadable directly so
preprocessed traces round-trip without the original files:

* CSV (plain or gzipped), ``#`` comments, one task per row, in any order::

      t_arrive, work, packets[, priority]

  The 3-column form is ``load_trace_csv``'s format (priority 0
  everywhere); the 4-column form adds the tier.
* optional sidecar (JSON) for the sparse axes — constraints, eviction
  events and end-of-life outcomes::

      {"attr_names": ["machine_class"],
       "rows": [[task_index, "machine_class", ">=", 2.0], ...],
       "evictions": [[task_index, time], ...],
       "ends_evicted": [task_index, ...],
       "deps": [[child_index, parent_index], ...],
       "out_size": [[task_index, bytes], ...]}

  ``task_index`` refers to the row's position in *arrival order* (the
  order :func:`load_normalized_csv` returns), ops are the spellings in
  :data:`repro_torch.traces.schema.OPS`, eviction times share ``t_arrive``'s
  clock. All keys are optional — constraints-only sidecars load
  unchanged.

Both files may be gzipped: loading sniffs magic bytes, writing goes by the
``.gz`` suffix.
"""

from __future__ import annotations

import contextlib
import gzip
import io as _io
import json
from pathlib import Path

import numpy as np

from .io import open_maybe_gzip, read_numeric_csv
from ..graphs import DagSpec
from .schema import OPS, Constraints, Evictions, TraceSchema

__all__ = ["load_normalized_csv", "write_normalized_csv"]


def _read_text(path) -> str:
    with open_maybe_gzip(path) as fh:
        return fh.read().decode()


@contextlib.contextmanager
def _text_writer(path):
    """Streaming text handle; gzipped when the path says so (mtime=0
    keeps archives byte-identical across regenerations)."""
    if str(path).endswith(".gz"):
        with open(path, "wb") as raw, \
                gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as gz, \
                _io.TextIOWrapper(gz) as fh:
            yield fh
    else:
        with open(path, "w") as fh:
            yield fh


def _write_text(path, text: str) -> None:
    with _text_writer(path) as fh:
        fh.write(text)


def _sniff_columns(path) -> int:
    from .io import iter_text_chunks
    for text in iter_text_chunks(path, chunk_bytes=1 << 16):
        for line in text.splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                return line.count(",") + 1
    return 3


def load_normalized_csv(path, *, constraints_path=None,
                        horizon: float | None = None,
                        chunk_bytes: int = 1 << 24) -> TraceSchema:
    """Load the normalized CSV (3 or 4 columns) into a TraceSchema."""
    n_cols = _sniff_columns(path)
    if n_cols not in (3, 4):
        raise ValueError(
            f"trace {path!r}: expected 3 columns (t_arrive, work, packets) "
            f"or 4 (+ priority), got {n_cols}")
    rows = read_numeric_csv(path, usecols=tuple(range(n_cols)),
                            chunk_bytes=chunk_bytes)
    if rows.shape[0] == 0:
        return TraceSchema(t_arrive=np.zeros(0), works=np.zeros(0),
                           packets=np.zeros(0))
    order = np.argsort(rows[:, 0], kind="stable")
    rows = rows[order]
    t, works, packets = rows[:, 0], rows[:, 1], rows[:, 2]
    if (works <= 0).any() or (packets <= 0).any():
        raise ValueError(f"trace {path!r}: work and packets must be > 0")
    tiers = (rows[:, 3].astype(np.int32) if n_cols == 4
             else np.zeros(rows.shape[0], np.int32))
    constraints, evictions, ends_evicted, dag = (Constraints(), Evictions(),
                                                 None, DagSpec())
    if constraints_path is not None:
        constraints, evictions, ends_evicted, dag = _load_sidecar(
            constraints_path, rows.shape[0])
    trace = TraceSchema(t_arrive=t, works=works, packets=packets,
                        priority=tiers, constraints=constraints,
                        evictions=evictions,
                        ends_evicted=(np.zeros(rows.shape[0], np.bool_)
                                      if ends_evicted is None
                                      else ends_evicted),
                        dag=dag)
    if horizon is not None:
        trace = trace.clipped(horizon)
    return trace


def _load_sidecar(path, m: int):
    d = json.loads(_read_text(path))
    names = tuple(d.get("attr_names", ()))
    idx = {a: i for i, a in enumerate(names)}
    rows = d.get("rows", ())
    task, attr, op, value = [], [], [], []
    for r in rows:
        tid, a, o, v = r
        if a not in idx:
            raise ValueError(f"constraints sidecar {path!r}: attribute "
                             f"{a!r} not in attr_names {sorted(idx)}")
        if o not in OPS:
            raise ValueError(f"constraints sidecar {path!r}: unknown op "
                             f"{o!r}; have {sorted(OPS)}")
        task.append(int(tid))
        attr.append(idx[a])
        op.append(OPS[o])
        value.append(float(v))
    ev_rows = d.get("evictions", ())
    evictions = Evictions(
        np.asarray([int(r[0]) for r in ev_rows], dtype=np.int64),
        np.asarray([float(r[1]) for r in ev_rows], dtype=np.float64))
    ends = np.zeros(m, dtype=np.bool_)
    for tid in d.get("ends_evicted", ()):
        if not 0 <= int(tid) < m:
            raise ValueError(f"sidecar {path!r}: ends_evicted index {tid} "
                             f"outside the {m}-task trace")
        ends[int(tid)] = True
    dag = DagSpec()
    deps = d.get("deps", ())
    sizes = d.get("out_size", ())
    if deps or sizes:
        out = np.zeros(m, dtype=np.float64)
        for r in sizes:
            tid, b = int(r[0]), float(r[1])
            if not 0 <= tid < m:
                raise ValueError(f"sidecar {path!r}: out_size index {tid} "
                                 f"outside the {m}-task trace")
            out[tid] = b
        try:
            dag = DagSpec(child=[int(r[0]) for r in deps],
                          parent=[int(r[1]) for r in deps],
                          out_size=out, m=m)
        except ValueError as e:
            raise ValueError(f"sidecar {path!r}: {e}") from None
    return Constraints(names, task, attr, op, value), evictions, ends, dag


def write_normalized_csv(trace: TraceSchema, path, *,
                         constraints_path=None) -> bool:
    """Inverse of :func:`load_normalized_csv` (the ``repro_torch.lab trace
    --out`` conversion target). The sidecar carries every sparse axis —
    constraints, eviction events, end-of-life outcomes — and is written
    only when ``constraints_path`` is given and at least one axis is
    non-empty; returns whether it was."""
    with _text_writer(path) as fh:
        fh.write("# t_arrive,work,packets,priority\n")
        for i in range(trace.m):
            fh.write(f"{trace.t_arrive[i]:.9g},{trace.works[i]:.9g},"
                     f"{trace.packets[i]:.9g},{int(trace.priority[i])}\n")
    has_sidecar_data = (not trace.constraints.empty
                        or not trace.evictions.empty
                        or bool(trace.ends_evicted.any())
                        or trace.has_dag)
    if constraints_path is None or not has_sidecar_data:
        return False
    from .schema import OP_NAMES
    c = trace.constraints
    payload = {
        "attr_names": list(c.attr_names),
        "rows": [[int(c.task[j]), c.attr_names[c.attr[j]],
                  OP_NAMES[int(c.op[j])], float(c.value[j])]
                 for j in range(c.k)],
        "evictions": [[int(trace.evictions.task[j]),
                       float(trace.evictions.time[j])]
                      for j in range(trace.evictions.k)],
        "ends_evicted": [int(i) for i in
                         np.flatnonzero(trace.ends_evicted)],
    }
    if trace.has_dag:
        dag = trace.dag
        payload["deps"] = [[int(c), int(p)]
                           for c, p in zip(dag.child, dag.parent)]
        payload["out_size"] = [[int(i), float(dag.out_size[i])]
                               for i in np.flatnonzero(dag.out_size)]
    _write_text(constraints_path, json.dumps(payload, indent=2) + "\n")
    return True
