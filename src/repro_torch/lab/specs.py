"""Declarative experiment specs: experiments are data, not code.

A :class:`Scenario` is a frozen, JSON-round-trippable description of one
simulation — cluster, workload, policy, fault schedule, seeds — independent
of *how* it is executed. Execution surfaces become interchangeable
:mod:`repro_torch.lab.backends` implementations over the same Scenario,
echoing the scenario x algorithm x metric matrix framing of the
scheduler-evaluation literature (Casanova et al. 2011; Dutot et al.).

Round-trip contract: ``Scenario.from_json(s.to_json())`` reproduces an equal
scenario with an identical :meth:`Scenario.fingerprint` — the fingerprint is
the stable identity that ties a :class:`repro_torch.lab.RunResult` back to
the experiment that produced it. The specs are field for field those of the
JAX package's ``repro.lab.specs``, so one scenario has one fingerprint in
both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import warnings
from dataclasses import dataclass, field, fields, replace
from types import MappingProxyType
from typing import Mapping

import numpy as np

from ..runtime.workload import (
    ARRIVAL_PROCESSES,
    Workload,
    load_trace_csv,
    make_workload,
)

__all__ = [
    "ClusterSpec",
    "WorkloadSpec",
    "TraceRef",
    "FaultSpec",
    "PolicySpec",
    "ObsSpec",
    "Scenario",
    "resolve_fault_schedule",
]


def _freeze(value):
    """Recursively convert lists to tuples and mappings to read-only
    proxies (at every depth) so frozen specs stay immutable (and ``==`` is
    structural) after a JSON round trip."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, Mapping):
        return MappingProxyType({k: _freeze(v) for k, v in value.items()})
    return value


def _frozen_params(params: Mapping) -> Mapping:
    """Read-only params mapping — mutating a frozen spec's params would
    silently desynchronise its fingerprint from already-produced results."""
    return _freeze(dict(params))


def _thaw(value):
    """Specs/tuples/mappings down to plain JSON types."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _thaw(getattr(value, f.name))
                for f in fields(value)}
    if isinstance(value, tuple):
        return [_thaw(v) for v in value]
    if isinstance(value, Mapping):
        return {k: _thaw(v) for k, v in value.items()}
    return value


# content-digest cache: re-hashing a million-row trace for every scenario
# in a sweep would dominate; (mtime_ns, size) invalidates edited files
_DIGEST_CACHE: dict[tuple, bytes] = {}

# materialized trace cache, keyed on (spec json, seed, content digest)
_TRACE_CACHE: dict[tuple, Workload] = {}

# parsed-trace cache: the expensive part of a TraceRef load is the file
# parse, which is seed-independent — a 64-seed sweep over a scaled trace
# must parse once and resample 64 times, not re-ingest 64 times
_PARSE_CACHE: dict[tuple, object] = {}


def _file_digest(path: str) -> bytes:
    try:
        st = os.stat(path)
    except OSError as exc:
        raise ValueError(f"trace file {path!r} unreadable: {exc}") from exc
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    if key not in _DIGEST_CACHE:
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for block in iter(lambda: fh.read(1 << 20), b""):
                h.update(block)
        if len(_DIGEST_CACHE) > 64:
            _DIGEST_CACHE.clear()
        _DIGEST_CACHE[key] = h.digest()
    return _DIGEST_CACHE[key]


class _SpecBase:
    """Shared dict/JSON plumbing for the frozen spec dataclasses."""

    def to_dict(self) -> dict:
        return _thaw(self)

    @classmethod
    def from_dict(cls, d: dict) -> "_SpecBase":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown fields {sorted(unknown)}")
        return cls(**{k: _freeze(v) for k, v in d.items()})

    def replace(self, **changes):
        return replace(self, **_freeze(changes))


@dataclass(frozen=True)
class ClusterSpec(_SpecBase):
    """The machine: node powers tau_i, hyper-grid dimension, migration
    bandwidth. Either ``powers`` is explicit, or ``n_nodes`` asks each
    backend to sample integer powers in ``power_low..power_high`` from
    ``power_seed`` (the paper's setup)."""

    powers: tuple[float, ...] | None = None
    n_nodes: int | None = None
    power_low: int = 1
    power_high: int = 10
    power_seed: int = 0
    d: int | None = None            # hyper-grid dimension; None = optimal_dim
    bandwidth: float = 64.0         # packets per time unit while migrating
    # intra-cluster data-fabric rate for DAG parent-output fetches
    # (bytes per time unit); None = same as the migration bandwidth
    link_bandwidth: float | None = None
    # node attribute table {name: (n,) values} — what trace placement
    # constraints ("machine_class >= 2") are evaluated against
    attrs: Mapping | None = None

    def __post_init__(self):
        if (self.powers is None) == (self.n_nodes is None):
            raise ValueError("give exactly one of powers / n_nodes")
        if self.powers is not None:
            object.__setattr__(self, "powers",
                               tuple(float(p) for p in self.powers))
            if any(p <= 0 for p in self.powers):
                raise ValueError("powers must be > 0")
        if self.attrs is not None:
            # same codec as trace constraint values: numeric stays itself,
            # an opaque string becomes its stable 48-bit hash code — so
            # spec files round-trip as plain floats and string-valued
            # trace predicates (==/!=) match exactly
            from ..traces.schema import hash_attr_value
            frozen = _freeze({str(k): tuple(hash_attr_value(x) for x in v)
                              for k, v in dict(self.attrs).items()})
            for name, vals in frozen.items():
                if len(vals) != self.size:
                    raise ValueError(
                        f"attr {name!r}: {len(vals)} values for "
                        f"{self.size} nodes")
            object.__setattr__(self, "attrs", frozen)

    @property
    def size(self) -> int:
        return len(self.powers) if self.powers is not None else self.n_nodes

    def resolve_powers(self) -> np.ndarray:
        """Concrete (n,) float64 powers for this cluster."""
        if self.powers is not None:
            return np.asarray(self.powers, dtype=np.float64)
        rng = np.random.default_rng(self.power_seed)
        return rng.integers(self.power_low, self.power_high + 1,
                            size=self.n_nodes).astype(np.float64)

    def resolve_attrs(self) -> dict | None:
        """Node attribute table as the runtime consumes it, or ``None``."""
        if self.attrs is None:
            return None
        return {k: tuple(v) for k, v in self.attrs.items()}


@dataclass(frozen=True)
class TraceRef(_SpecBase):
    """A reference to a real-trace file parsed by :mod:`repro_torch.traces`.

    ``format`` picks the parser (``csv`` | ``google`` | ``azure``),
    ``params`` its keyword arguments (``constraints_path``,
    ``vmtypes_path``, ``eviction_mode``, ``time_scale``, ...). ``scale``
    bootstraps an Nx-rate workload from the trace via
    :func:`repro_torch.traces.trace_scale`, driven by the *scenario* seed — a
    seed sweep over a scaled trace is a real ensemble, where a raw replay
    ignores the seed axis entirely.

    ``machine_events`` names a companion Google machine_events file: its
    capacity churn (REMOVE/ADD/UPDATE) is parsed into failure/join/resize
    events and merged into the scenario's fault schedule at run time
    (:func:`resolve_fault_schedule`), so a trace replay carries the
    cluster's churn as well as its workload.
    """

    path: str = ""
    format: str = "csv"
    params: dict = field(default_factory=dict)
    scale: float | None = None
    machine_events: str | None = None

    def __post_init__(self):
        from ..traces import TRACE_FORMATS
        if not self.path:
            raise ValueError("TraceRef needs a path")
        if self.format not in TRACE_FORMATS:
            raise ValueError(f"unknown trace format {self.format!r}; "
                             f"have {sorted(TRACE_FORMATS)}")
        if self.scale is not None and self.scale <= 0:
            raise ValueError(f"scale must be > 0, got {self.scale}")
        # reject typo'd parser params here, not as a mid-run TypeError
        fn = TRACE_FORMATS[self.format]
        allowed = {p.name for p in
                   inspect.signature(fn).parameters.values()
                   if p.kind == p.KEYWORD_ONLY}
        unknown = set(self.params) - allowed
        if unknown:
            raise ValueError(
                f"trace format {self.format!r} params {sorted(unknown)} "
                f"unknown; accepted: {sorted(allowed)}")
        object.__setattr__(self, "params", _frozen_params(self.params))

    def side_paths(self) -> tuple[str, ...]:
        """Companion files (constraint tables, vmType joins, machine
        events) whose contents are part of this reference's identity."""
        paths = [str(v) for k, v in sorted(self.params.items())
                 if k.endswith("_path") and v is not None]
        if self.machine_events:
            paths.append(str(self.machine_events))
        return tuple(paths)

    def load_machine_events(self, t_zero: float = 0.0):
        """Parse the referenced machine_events file into a
        :class:`repro_torch.traces.MachineSchedule` (empty when unset). Memoized
        on file contents alongside the trace parse. ``t_zero`` is the raw
        timestamp the workload's clock starts at (``TraceSchema.
        t_zero_raw``) — the Google public trace begins at 600s, and an
        unaligned schedule would fire every capacity event late."""
        from ..traces import MachineSchedule, load_google_machine_events
        if not self.machine_events:
            return MachineSchedule()
        # google stamps microseconds; the normalized CSV is in plain time
        # units — share the trace's own clock scaling either way
        default_ts = 1e-6 if self.format == "google" else 1.0
        time_scale = float(self.params.get("time_scale", default_ts))
        key = ("machine_events", self.machine_events, time_scale,
               float(t_zero), _file_digest(self.machine_events))
        if key not in _PARSE_CACHE:
            if len(_PARSE_CACHE) >= 4:
                _PARSE_CACHE.clear()
            _PARSE_CACHE[key] = load_google_machine_events(
                self.machine_events, time_scale=time_scale,
                t_zero=float(t_zero))
        return _PARSE_CACHE[key]

    def load(self, seed: int):
        """Parse (and optionally rescale) the referenced trace. The
        seed-independent parse is memoized on (ref-sans-scale, file
        contents); only the cheap per-seed resample runs per call."""
        from ..traces import load_trace, trace_scale
        key = (self.path, self.format,
               json.dumps(_thaw(self.params), sort_keys=True),
               tuple(_file_digest(p)
                     for p in (self.path, *self.side_paths())))
        if key not in _PARSE_CACHE:
            if len(_PARSE_CACHE) >= 4:
                _PARSE_CACHE.clear()
            _PARSE_CACHE[key] = load_trace(self.path, format=self.format,
                                           params=dict(self.params))
        trace = _PARSE_CACHE[key]
        if self.scale is None:
            return trace
        return trace_scale(trace, float(self.scale), seed=seed)


@dataclass(frozen=True)
class WorkloadSpec(_SpecBase):
    """The offered load: an arrival process over the paper's work/packet
    marginals, or a trace file. ``params`` are the process kwargs
    (``rate``, ``rate_hi``, ...); the realization seed lives on the
    Scenario so sweeps can vary it alone.

    Trace workloads come in two spellings: ``trace_path`` (a bare
    3-column CSV) and ``trace=TraceRef(...)`` (real-trace formats with
    priorities, constraints and rate scaling)."""

    process: str = "poisson"
    horizon: float | None = 100.0  # None = whole trace (traces only)
    work_dist: str = "uniform"
    work_mean: float = 4.0
    packet_mean: float = 8.0
    params: dict = field(default_factory=dict)
    trace_path: str | None = None   # CSV of t_arrive,work,packets; overrides
                                    # process/work_dist sampling entirely
    trace: TraceRef | None = None   # real-trace reference (repro_torch.traces)
    m_tasks: int | None = None      # task-count override for the static
                                    # legacy backend (paper: 4000)
    # task-dependency DAG: either a generator spec ({"kind": "chain" |
    # "diamond" | "fanin_fanout" | "random", "out_size": ..., ...},
    # realized against the materialized task count with the scenario seed)
    # or explicit {"edges": [[child, parent], ...], "out_size": [...]}
    dag: Mapping | None = None

    def __post_init__(self):
        if isinstance(self.trace, Mapping):
            object.__setattr__(self, "trace",
                               TraceRef.from_dict(_thaw(self.trace)))
        if self.trace_path is not None and self.trace is not None:
            raise ValueError("give at most one of trace_path / trace")
        if self.trace_path is None and self.trace is None:
            if self.process not in ARRIVAL_PROCESSES:
                raise ValueError(
                    f"unknown arrival process {self.process!r}; "
                    f"have {sorted(ARRIVAL_PROCESSES)}")
            if self.horizon is None:
                raise ValueError("horizon=None (replay everything) needs a "
                                 "trace_path or trace; arrival processes "
                                 "need a horizon")
            # reject typo'd process params here, not as a mid-run TypeError
            fn = ARRIVAL_PROCESSES[self.process]
            allowed = {p.name for p in
                       inspect.signature(fn).parameters.values()
                       if p.kind == p.KEYWORD_ONLY}
            unknown = set(self.params) - allowed
            if unknown:
                raise ValueError(
                    f"process {self.process!r} params {sorted(unknown)} "
                    f"unknown; accepted: {sorted(allowed)}")
        object.__setattr__(self, "params", _frozen_params(self.params))
        if self.dag is not None:
            if not isinstance(self.dag, Mapping):
                raise ValueError(
                    "dag must be a mapping: a generator spec "
                    '({"kind": ...}) or explicit edges ({"edges": ...})')
            d = dict(self.dag)
            if "edges" not in d:
                from ..graphs import DAG_KINDS
                if d.get("kind") not in DAG_KINDS:
                    raise ValueError(
                        f"dag needs 'edges' or a 'kind' in "
                        f"{sorted(DAG_KINDS)}; got {sorted(d) or '{}'}")
            object.__setattr__(self, "dag", _frozen_params(d))

    @property
    def is_trace(self) -> bool:
        return self.trace_path is not None or self.trace is not None

    def trace_files(self) -> tuple[str, ...]:
        """Every file this workload's identity depends on."""
        if self.trace_path is not None:
            return (self.trace_path,)
        if self.trace is not None:
            return (self.trace.path, *self.trace.side_paths())
        return ()

    def content_digest(self) -> str | None:
        """sha256 over the referenced trace files' *contents* (chained in
        path order), or ``None`` for synthetic workloads. This is what
        makes two different files at the same path fingerprint apart."""
        files = self.trace_files()
        if not files:
            return None
        h = hashlib.sha256()
        for p in files:
            h.update(_file_digest(p))
        return h.hexdigest()

    def _clip(self, wl: Workload, label: str) -> Workload:
        """Horizon truncation, loudly — a silently clipped replay would be
        attributed to the whole trace."""
        if self.horizon is None or not wl.m:
            return wl
        keep = wl.t_arrive < self.horizon
        kept = int(keep.sum())
        if kept == wl.m:
            return wl
        warnings.warn(
            f"trace {label!r}: {wl.m - kept} of {wl.m} tasks arrive "
            f"at/after horizon={self.horizon} and are dropped (declare "
            f'"horizon": null to replay everything)', stacklevel=3)
        if hasattr(wl, "clipped"):
            return wl.clipped(self.horizon)
        return Workload(t_arrive=wl.t_arrive[keep], works=wl.works[keep],
                        packets=wl.packets[keep])

    def materialize(self, seed: int) -> Workload:
        """One concrete realization of this workload. Trace loads are
        memoized on (spec, seed, file contents): eligibility checks and the
        run itself would otherwise each re-ingest a million-row file."""
        if self.trace is None and self.trace_path is None:
            wl = make_workload(self.process, horizon=self.horizon,
                               work_dist=self.work_dist,
                               work_mean=self.work_mean,
                               packet_mean=self.packet_mean,
                               seed=seed, **self.params)
            return self._attach_dag(wl, seed)
        key = (json.dumps(self.to_dict(), sort_keys=True), int(seed),
               self.content_digest())
        if key not in _TRACE_CACHE:
            if self.trace is not None:
                wl = self._clip(self.trace.load(seed), self.trace.path)
            else:
                wl = self._clip(load_trace_csv(self.trace_path),
                                self.trace_path)
            if len(_TRACE_CACHE) >= 8:
                _TRACE_CACHE.clear()
            _TRACE_CACHE[key] = self._attach_dag(wl, seed)
        return _TRACE_CACHE[key]

    def _attach_dag(self, wl: Workload, seed: int) -> Workload:
        """Realize ``dag`` against the materialized task count (generator
        kinds draw from the scenario seed, so a seed sweep over a random
        DAG is a real ensemble) and attach it as a TraceSchema field."""
        if self.dag is None:
            return wl
        from ..graphs import make_dag
        from ..traces.schema import TraceSchema
        existing = getattr(wl, "dag", None)
        if existing is not None and not existing.empty:
            raise ValueError(
                "the trace already carries dependency edges; drop "
                "WorkloadSpec(dag=...) or the sidecar's deps")
        dag = make_dag(_thaw(self.dag), wl.m, seed)
        if isinstance(wl, TraceSchema):
            return dataclasses.replace(wl, dag=dag)
        return TraceSchema(t_arrive=wl.t_arrive, works=wl.works,
                           packets=wl.packets, dag=dag)


@dataclass(frozen=True)
class FaultSpec(_SpecBase):
    """Node failure/rejoin/resize schedule: ``failures``/``joins`` are
    ``(time, node)`` pairs; ``resizes`` are ``(time, node, fraction)``
    capacity changes (the node's power becomes ``fraction`` of its base
    power — machine_events UPDATE semantics)."""

    failures: tuple[tuple[float, int], ...] = ()
    joins: tuple[tuple[float, int], ...] = ()
    resizes: tuple[tuple[float, int, float], ...] = ()

    def __post_init__(self):
        for name in ("failures", "joins"):
            evs = tuple((float(t), int(n)) for t, n in getattr(self, name))
            object.__setattr__(self, name, evs)
        rs = tuple((float(t), int(n), float(f)) for t, n, f in self.resizes)
        if any(f < 0 for _, _, f in rs):
            raise ValueError("resize fractions must be >= 0")
        object.__setattr__(self, "resizes", rs)

    @property
    def empty(self) -> bool:
        return not self.failures and not self.joins and not self.resizes


@dataclass(frozen=True)
class PolicySpec(_SpecBase):
    """The algorithm under test: a name from the runtime policy registry
    plus its constructor kwargs and the trigger evaluation period.

    ``constraint_mode`` only matters for constrained traces: ``"aware"``
    hands the policy each task's feasibility mask; ``"blind"`` hides it
    (the engine still *enforces* constraints either way — blind is the
    constraint-unaware dispatch baseline, not a correctness toggle)."""

    name: str = "psts"
    trigger_period: float = 2.0
    params: dict = field(default_factory=dict)
    constraint_mode: str = "aware"

    def __post_init__(self):
        if self.constraint_mode not in ("aware", "blind"):
            raise ValueError(
                f"constraint_mode must be 'aware' or 'blind', "
                f"got {self.constraint_mode!r}")
        object.__setattr__(self, "params", _frozen_params(self.params))


@dataclass(frozen=True)
class ObsSpec(_SpecBase):
    """Telemetry to collect while the scenario runs (:mod:`repro_torch.obs`).

    ``trace`` records per-task lifecycle spans and per-decision scheduler
    latency (Chrome-trace export lands in ``extras["obs"]["chrome_trace"]``);
    ``probe_every`` samples the live-cluster probe series on that cadence
    (simulated time units); ``ring`` bounds tracer memory to the newest N
    events. Telemetry never changes what the experiment *is*: ``obs`` is
    excluded from :meth:`Scenario.fingerprint`, and the conformance tests
    assert it changes no metric.

    The ops plane rides the same spec: ``metrics`` installs a
    registry collector as the engine's decision sink; ``anomaly`` runs an
    anomaly monitor on the probe chain (requires ``probe_every``) with
    optional ``anomaly_params`` forwarded to its constructor. Both belong
    to the event engine; the batched backend reads only ``probe_every`` and
    flags ``trace``.

    ``latency_sample`` is the placement-latency sampling stride: the
    engine times 1-in-``latency_sample`` placements (deterministically)
    and records each sample with that weight, so ``decision_stats()``
    reports the full decision count and percentiles ranked against it.
    ``1`` means a census — every placement timed; the default ``8``
    keeps timing overhead off the hot path.
    """

    trace: bool = True
    probe_every: float | None = None
    ring: int | None = None
    metrics: bool = False
    anomaly: bool = False
    anomaly_params: dict | None = None
    latency_sample: int = 8

    def __post_init__(self):
        if self.probe_every is not None and not self.probe_every > 0:
            raise ValueError(
                f"probe_every must be > 0, got {self.probe_every}")
        if self.ring is not None and self.ring <= 0:
            raise ValueError(f"ring must be > 0, got {self.ring}")
        if self.latency_sample < 1:
            raise ValueError(
                f"latency_sample must be >= 1, got {self.latency_sample}")
        if self.anomaly and self.probe_every is None:
            raise ValueError(
                "anomaly detection rides the probe chain; set probe_every")
        if self.anomaly_params is not None:
            object.__setattr__(self, "anomaly_params",
                               _frozen_params(self.anomaly_params))


def resolve_fault_schedule(scenario) -> tuple[tuple, tuple, tuple]:
    """The scenario's complete ``(failures, joins, resizes)`` schedule:
    declared :class:`FaultSpec` events merged with the capacity churn of
    the workload trace's ``machine_events`` companion (if any). Every
    backend and the federation runtime drive engines from this resolution,
    so declared and trace-derived churn compose instead of competing.

    A resize to a non-positive fraction is a removal in disguise — it is
    normalized into a *failure* here, so the event engine and the batched
    power-scale lowering see one semantics (the node is down until a
    join, which restores its last positive resize fraction), instead of
    each backend improvising its own reading."""
    faults = scenario.faults
    failures = list(faults.failures)
    joins = list(faults.joins)
    resizes = list(faults.resizes)
    trace = getattr(scenario.workload, "trace", None)
    if trace is not None and trace.machine_events:
        # align the machine clock with the workload clock: t_arrive=0 is
        # the trace's raw t_zero (memoized materialization, already done
        # for eligibility)
        wl = scenario.workload.materialize(scenario.seed)
        sched = trace.load_machine_events(
            t_zero=getattr(wl, "t_zero_raw", 0.0))
        failures += list(sched.failures)
        joins += list(sched.joins)
        resizes += list(sched.resizes)
    failures += [(t, node) for t, node, f in resizes if f <= 0]
    resizes = [(t, node, f) for t, node, f in resizes if f > 0]
    return tuple(failures), tuple(joins), tuple(resizes)


_SECTIONS = {"cluster": ClusterSpec, "workload": WorkloadSpec,
             "policy": PolicySpec, "faults": FaultSpec, "obs": ObsSpec}


@dataclass(frozen=True)
class Scenario(_SpecBase):
    """One complete experiment description.

    ``seed`` drives the workload realization (the natural sweep axis);
    ``engine_seed`` drives engine-owned randomness (stochastic policies,
    tie-breaks) and is held fixed across a seed sweep.
    """

    cluster: ClusterSpec
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    policy: PolicySpec = field(default_factory=PolicySpec)
    faults: FaultSpec = field(default_factory=FaultSpec)
    seed: int = 0
    engine_seed: int = 0
    name: str = ""
    # what telemetry to collect (None = no instrumentation, zero cost);
    # deliberately NOT part of the fingerprint — observing an experiment
    # does not change which experiment it is
    obs: ObsSpec | None = None

    # -- serialization ------------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        for key, section_cls in _SECTIONS.items():
            if key in d and isinstance(d[key], dict):
                d[key] = section_cls.from_dict(d[key])
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Scenario: unknown fields {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> dict:
        # an un-instrumented scenario serializes exactly as it did before
        # telemetry existed — old spec files and sweep-uniformity keys are
        # unaffected
        d = _thaw(self)
        if self.obs is None:
            d.pop("obs", None)
        return d

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        return cls.from_dict(json.loads(text))

    def fingerprint(self) -> str:
        """Stable 16-hex-digit identity of the canonical JSON form.

        Trace workloads additionally fold in a sha256 of the referenced
        files' *contents* — two different files at the same path must not
        collide in sweep caches or result attribution, and a trace edited
        between runs is a different experiment.
        """
        d = self.to_dict()
        # telemetry is not identity: an instrumented run must attribute to
        # the same experiment as its un-instrumented twin
        d.pop("obs", None)
        canon = json.dumps(d, sort_keys=True, separators=(",", ":"))
        digest = self.workload.content_digest()
        if digest is not None:
            canon += f"|trace-sha256:{digest}"
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    # -- grid support -------------------------------------------------------
    def updated(self, assignments: dict) -> "Scenario":
        """A copy with dotted-path fields replaced: ``{"seed": 3,
        "policy.params.floor": 0.1, "cluster.d": 2}``. The mechanism behind
        :func:`repro_torch.lab.sweep` grids."""
        d = self.to_dict()
        for path, value in assignments.items():
            node = d
            *parents, leaf = path.split(".")
            for p in parents:
                if not isinstance(node.get(p), dict):
                    raise KeyError(f"no such scenario section: {path!r}")
                node = node[p]
            node[leaf] = _thaw(value)
        return Scenario.from_dict(d)


def _spec_hash(self) -> int:
    """Hash by canonical JSON identity — the generated dataclass hash
    would choke on the read-only params mappings, and frozen specs invite
    set/dict use (dedup of expanded grids, scenario-keyed result maps)."""
    return hash((type(self).__name__,
                 json.dumps(self.to_dict(), sort_keys=True)))


for _cls in (ClusterSpec, WorkloadSpec, TraceRef, FaultSpec, PolicySpec,
             ObsSpec, Scenario):
    _cls.__hash__ = _spec_hash
