"""Backend protocol + the three registered execution surfaces.

* ``"events"``  — the scalar discrete-event engine (``runtime.ClusterRuntime``):
  full fidelity, per-task state, any registered policy, faults, migration
  bandwidth. The reference semantics. Host code: it never touches the GPU.
* ``"batched"`` — the vectorized fluid backend (``runtime.vector_backend``):
  B scenarios as one batched run on the GPU, through the hand-written scan
  and dispatch kernels. Positional policies only (``arrival_only``/``psts``)
  — it carries no per-task migration histories — and faults become a power
  up/down schedule.
* ``"legacy"``  — the static paper simulator (``core.simulator``): one
  snapshot, one full PSTS pass, the section-5 cost model. No faults, no
  arrival staggering; it alone derives crossover points (Tables 6-7). Host
  code, like ``events``.

Two more register from other packages, imported lazily by
:func:`get_backend`: ``federated`` from :mod:`repro_torch.federation`, and
``online`` (the scheduler service, host code like ``events``) from
:mod:`repro_torch.serve`. Eligibility reasons and results are those of
``repro.lab.backends``, word for word, so the two packages can be held
against each other.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from ..core.hypergrid import embed, optimal_dim
from ..core.simulator import SimConfig, simulate
from ..core.trigger import CrossoverTrigger
from ..obs import build_instruments, export_obs
from ..runtime.policies import PstsPolicy, make_policy
from ..runtime.runtime import ClusterRuntime, InfeasibleTaskError
from ..runtime.vector_backend import VectorConfig, simulate_batch
from ..runtime.workload import ARRIVAL_PROCESSES, batch_slots
from ..traces import TraceSchema
from .result import RunResult, make_metrics
from .specs import Scenario, resolve_fault_schedule

__all__ = [
    "Backend",
    "BackendError",
    "BACKENDS",
    "register_backend",
    "get_backend",
    "EventsBackend",
    "BatchedBackend",
    "LegacyBackend",
    "BATCHED_POLICIES",
    "build_events_runtime",
    "assemble_events_result",
    "events_eligible",
]

# policies expressible without per-task state (the batched backend's limit)
BATCHED_POLICIES = ("arrival_only", "psts")

# cost-model constants a PolicySpec may override — derived from PstsPolicy's
# own fields so the batched/legacy param validation stays in lockstep with
# what the events backend's constructor accepts
_COST_KEYS = tuple(f.name for f in dataclasses.fields(PstsPolicy))


class BackendError(ValueError):
    """Scenario not eligible on the requested backend."""


class Backend:
    """One execution surface. Subclasses register under ``BACKENDS``."""

    name: str = "?"

    def eligible(self, scenario: Scenario) -> str | None:
        """Reason this scenario cannot run here, or ``None`` if it can."""
        return None

    def check(self, scenario: Scenario) -> None:
        reason = self.eligible(scenario)
        if reason is not None:
            raise BackendError(f"backend {self.name!r}: {reason}")

    def run(self, scenario: Scenario, **options) -> RunResult:
        raise NotImplementedError


BACKENDS: dict[str, Backend] = {}


def register_backend(cls: type[Backend]) -> type[Backend]:
    BACKENDS[cls.name] = cls()
    return cls


def get_backend(name: str) -> Backend:
    if name == "federated" and name not in BACKENDS:
        # registration lives in repro_torch.federation, which imports this
        # module; importing it eagerly at module top would be a cycle
        from ..federation import backend as _federation_backend  # noqa: F401
    if name == "online" and name not in BACKENDS:
        # the scheduler-as-a-service backend lives in repro_torch.serve;
        # same cycle-avoidance as the federated hook above
        from ..serve import backend as _serve_backend  # noqa: F401
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {sorted(BACKENDS)}")
    return BACKENDS[name]


# fields allowed to differ between scenarios sharing one batched compile
# (the workload-realization axes)
SEED_FIELDS = ("seed", "name")


def uniform_but_for_seed(scenarios: list[Scenario]) -> bool:
    """True when the scenarios differ only in workload seed/name — the
    shape the batched backend can run as one compiled batch."""
    def key(sc):
        d = sc.to_dict()
        for f in SEED_FIELDS:
            d.pop(f, None)
        return json.dumps(d, sort_keys=True)
    first = key(scenarios[0])
    return all(key(sc) == first for sc in scenarios[1:])


def _single_cluster_only(spec) -> str | None:
    """Federations (duck-typed on ``is_federation``, as in the JAX package,
    where the federation package imports this module) only run on the
    federated backend."""
    if getattr(spec, "is_federation", False):
        return ("a Federation composes member Scenarios; run it on the "
                "'federated' backend")
    return None


def _unknown_policy_params(scenario: Scenario) -> str | None:
    """Mirror the events backend's constructor check: a param the policy
    cannot take must be an eligibility error everywhere, never silently
    dropped — otherwise auto-dispatch would make the same typo'd sweep fail
    or run depending on its size. Only psts carries cost constants."""
    allowed = set(_COST_KEYS) if scenario.policy.name == "psts" else set()
    unknown = set(scenario.policy.params) - allowed
    if unknown:
        return (f"policy {scenario.policy.name!r} params not expressible "
                f"here: {sorted(unknown)} (accepted: {sorted(allowed)})")
    return None


def _fault_nodes_in_range(scenario: Scenario) -> str | None:
    n = scenario.cluster.size
    for t, node in scenario.faults.failures + scenario.faults.joins:
        if not 0 <= node < n:
            return f"fault event at t={t} names node {node} outside 0..{n - 1}"
    for t, node, _ in scenario.faults.resizes:
        if not 0 <= node < n:
            return (f"resize event at t={t} names node {node} outside "
                    f"0..{n - 1}")
    return None


def _dag_problem(scenario: Scenario) -> str | None:
    """A DAG spec that cannot be realized (explicit edges sized for a
    different task count, a bad generator param) must surface as an
    eligibility reason, not a mid-run traceback. Trace workloads are
    covered by :func:`_trace_problem`'s materialization."""
    if scenario.workload.dag is None or scenario.workload.is_trace:
        return None
    try:
        scenario.workload.materialize(scenario.seed)
    except Exception as exc:  # noqa: BLE001 — surface any realization failure
        return f"workload dag unrealizable: {exc}"
    return None


def _trace_problem(scenario: Scenario) -> str | None:
    """A missing/unparseable trace (or machine_events companion) must be an
    eligibility reason, not a mid-run traceback after the 'backends' report
    said eligible."""
    if not scenario.workload.is_trace:
        return None
    label = (scenario.workload.trace_path
             or scenario.workload.trace.path)
    try:  # memoized: the run itself reuses this materialization
        scenario.workload.materialize(scenario.seed)
    except Exception as exc:  # noqa: BLE001 — surface any load failure
        return f"trace {label!r} unreadable: {exc}"
    trace = scenario.workload.trace
    if trace is not None and trace.machine_events:
        wl = scenario.workload.materialize(scenario.seed)
        try:
            sched = trace.load_machine_events(
                t_zero=getattr(wl, "t_zero_raw", 0.0))
        except Exception as exc:  # noqa: BLE001
            return (f"machine_events {trace.machine_events!r} unreadable: "
                    f"{exc}")
        if sched.n_machines > scenario.cluster.size:
            return (f"machine_events {trace.machine_events!r} describes "
                    f"{sched.n_machines} machines but the cluster has "
                    f"{scenario.cluster.size} nodes")
    return None


def _constraint_problem(scenario: Scenario) -> str | None:
    """Constrained traces must be satisfiable on this cluster: every
    constraint attribute declared, every task with >= 1 feasible node."""
    if not scenario.workload.is_trace:
        return None
    wl = scenario.workload.materialize(scenario.seed)
    if not isinstance(wl, TraceSchema) or not wl.constrained:
        return None
    attrs = scenario.cluster.resolve_attrs()
    names = tuple(sorted(attrs)) if attrs else ()
    matrix = (np.stack([np.asarray(attrs[a], dtype=np.float64)
                        for a in names], axis=1)
              if names else np.zeros((scenario.cluster.size, 0)))
    try:
        wl.feasibility(names, matrix)
    except InfeasibleTaskError as exc:
        return str(exc)
    return None


# ---------------------------------------------------------------------------
# events — scalar discrete-event engine (host code)
# ---------------------------------------------------------------------------

def build_events_runtime(scenario: Scenario, **runtime_extra):
    """Shared lowering for the events backend and the online
    (scheduler-as-a-service) backend: one scenario becomes one configured
    :class:`~repro_torch.runtime.ClusterRuntime` plus its realized workload,
    instruments, and fault schedule. Keeping construction in one place is
    what makes online/offline ``Metrics.summary()`` byte-identical."""
    wl = scenario.workload.materialize(scenario.seed)
    faults = resolve_fault_schedule(scenario)
    ins = build_instruments(scenario.obs)
    rt = ClusterRuntime(
        scenario.cluster.resolve_powers(), scenario.policy.name,
        d=scenario.cluster.d,
        trigger_period=scenario.policy.trigger_period,
        bandwidth=scenario.cluster.bandwidth,
        link_bandwidth=scenario.cluster.link_bandwidth,
        seed=scenario.engine_seed,
        policy_kwargs=dict(scenario.policy.params),
        node_attrs=scenario.cluster.resolve_attrs(),
        constraint_blind=scenario.policy.constraint_mode == "blind",
        **ins.runtime_kwargs(), **runtime_extra)
    return rt, wl, ins, faults


def assemble_events_result(scenario: Scenario, rt, wl, ins, *,
                           backend: str, backend_options: dict) -> RunResult:
    """Shared result assembly for the events/online backends: the same
    metrics schema and the same extras (tier breakdowns, work census,
    telemetry export) regardless of whether the trace was replayed offline
    or streamed in incrementally."""
    m = rt.metrics
    if scenario.workload.m_tasks is not None:
        # the realized arrival process decides the count here
        backend_options.setdefault("ignored", []).append(
            "workload.m_tasks")
    extras = {}
    if isinstance(wl, TraceSchema) and (wl.n_tiers > 1
                                        or wl.constrained):
        # the per-tier breakdown trace experiments compare policies
        # on; keys are strings so the result JSON round-trips
        extras["wait_by_tier"] = {
            str(tier): stats for tier, stats in m.wait_by_tier().items()
        }
        extras["tier_counts"] = {
            str(t): c for t, c in wl.tier_counts().items()}
    wl_dag = getattr(wl, "dag", None)
    if (isinstance(wl, TraceSchema) and (wl.preempted
                                         or wl.ends_evicted.any())) \
            or (wl_dag is not None and not wl_dag.empty):
        # end-of-run work audit for churn replays and DAG frontiers:
        # everything admitted is completed, and the waste the churn
        # burned is on record
        extras["work_census"] = {
            k: v for k, v in rt.work_census().items()
            if k in ("admitted", "completed", "wasted",
                     "in_flight", "conservation_gap")}
    if ins.any:
        extras["obs"] = export_obs(ins)
    return RunResult(
        fingerprint=scenario.fingerprint(), backend=backend,
        backend_options=backend_options,
        metrics=make_metrics(**m.summary()),
        extras=extras,
        scenario_name=scenario.name)


def events_eligible(scenario: Scenario) -> str | None:
    """Eligibility for the discrete-event engine (shared by the events and
    online backends — anything the engine can replay it can also stream)."""
    bad = _single_cluster_only(scenario)
    if bad is not None:
        return bad
    try:  # unknown names AND param/constructor mismatches, one reason
        make_policy(scenario.policy.name, **dict(scenario.policy.params))
    except (TypeError, ValueError) as exc:
        return str(exc)
    return (_fault_nodes_in_range(scenario) or _dag_problem(scenario)
            or _trace_problem(scenario) or _constraint_problem(scenario))


@register_backend
class EventsBackend(Backend):
    name = "events"

    def eligible(self, scenario):
        return events_eligible(scenario)

    def run(self, scenario, **options):
        self.check(scenario)
        if options:
            raise TypeError(f"events backend takes no options: "
                            f"{sorted(options)}")
        rt, wl, ins, (failures, joins, resizes) = \
            build_events_runtime(scenario)
        rt.run(wl, failures=failures, joins=joins, resizes=resizes)
        return assemble_events_result(
            scenario, rt, wl, ins, backend=self.name,
            backend_options={"model": "discrete-event"})


# ---------------------------------------------------------------------------
# batched — vectorized fluid backend (one batched run over B scenarios)
# ---------------------------------------------------------------------------

@register_backend
class BatchedBackend(Backend):
    name = "batched"
    default_dt = 1.0

    def eligible(self, scenario):
        bad = _single_cluster_only(scenario)
        if bad is not None:
            return bad
        if scenario.policy.name not in BATCHED_POLICIES:
            return (f"policy {scenario.policy.name!r} needs per-task state; "
                    f"the batched backend supports positional policies only "
                    f"({', '.join(BATCHED_POLICIES)})")
        bad = _unknown_policy_params(scenario)
        if bad is not None:
            return bad
        if scenario.workload.dag is not None:
            return ("workload declares a task-dependency DAG; the fluid "
                    "model has no per-task identity to gate releases on "
                    "parent completions — run on the events backend")
        bad = _fault_nodes_in_range(scenario) or _trace_problem(scenario)
        if bad is not None:
            return bad
        if scenario.workload.is_trace:
            wl = scenario.workload.materialize(scenario.seed)
            if isinstance(wl, TraceSchema) and wl.has_dag:
                return ("trace carries dependency edges; the fluid model "
                        "has no per-task identity to gate releases on "
                        "parent completions — run on the events backend")
            if isinstance(wl, TraceSchema) and wl.constrained:
                return ("trace tasks carry placement constraints; the "
                        "fluid model has no per-task node identity to "
                        "enforce a feasibility mask — run on the events "
                        "backend")
            if isinstance(wl, TraceSchema) and wl.preempted:
                return ("trace carries eviction (requeue) events; the "
                        "fluid model has no per-task identity to preempt "
                        "— run on the events backend, or parse with "
                        "eviction_mode='end'")
        failures, joins, _ = resolve_fault_schedule(scenario)
        failed_at: dict[int, float] = {}
        for t, node in sorted(failures):
            failed_at.setdefault(node, t)
        for t, node in joins:
            if node not in failed_at or failed_at[node] >= t:
                return (f"join of node {node} at t={t} has no earlier "
                        f"failure; the batched backend models faults as a "
                        f"power up/down schedule")
        # the fluid model cannot park work during a total outage (the
        # events backend can); reject schedules that zero the capacity
        n = scenario.cluster.size
        down: set[int] = set()
        for t, node, up in sorted(
                [(t, nd, False) for t, nd in failures]
                + [(t, nd, True) for t, nd in joins]):
            down.discard(node) if up else down.add(node)
            if len(down) == n:
                return (f"all {n} nodes down at t={t}; the fluid model "
                        f"cannot hold work through a total outage — use "
                        f"the events backend")
        return None

    # -- scenario -> tensors -----------------------------------------------
    def compile(self, scenarios: list[Scenario], dt: float,
                fifo_dispatch: bool = False):
        """Shared lowering for run/run_many: (slot, works, powers, cfg,
        power_scale). All scenarios must share cluster/policy/faults/
        workload shape (only seeds may differ)."""
        if not uniform_but_for_seed(scenarios):
            raise BackendError(
                "batched batch: scenarios must be identical except for "
                "seed/name (one cluster, policy, fault schedule and "
                "workload shape per compile)")
        base = scenarios[0]
        powers = base.cluster.resolve_powers()
        n = int(powers.size)
        wls = [sc.workload.materialize(sc.seed) for sc in scenarios]
        horizon = base.workload.horizon
        if horizon is None:  # whole-trace replay: cover the last arrival
            horizon = max((wl.horizon for wl in wls), default=0.0) + dt
        # ceil, not round: a final partial slot must still admit arrivals
        # in [floor(horizon/dt)*dt, horizon) or the backends diverge
        n_slots = max(int(math.ceil(horizon / dt - 1e-9)), 1)
        pol = base.policy
        # unset cost constants fall back to the PSTS policy's own defaults
        # (not VectorConfig's) so the same Scenario runs the same trigger
        # hysteresis on the events and batched backends
        defaults = PstsPolicy()
        cost = {k: float(pol.params.get(k, getattr(defaults, k)))
                for k in _COST_KEYS}
        if base.workload.is_trace:
            # a trace carries its own packet/work ratio; the spec's
            # sampling means are never read for traces
            tot_w = sum(float(wl.works.sum()) for wl in wls)
            packets_per_unit = (sum(float(wl.packets.sum()) for wl in wls)
                                / max(tot_w, 1e-12))
        else:
            # sample_packets draws 1 + Poisson(packet_mean), so the
            # realized mean is packet_mean + 1
            packets_per_unit = ((1.0 + base.workload.packet_mean)
                                / base.workload.work_mean)
        cfg = VectorConfig(
            n_nodes=n, n_slots=n_slots, dt=float(dt),
            rebalance=(pol.name == "psts"),
            packets_per_unit=packets_per_unit,
            fifo_dispatch=fifo_dispatch,
            # probes are per-slot engine outputs; lifecycle tracing has no
            # fluid analogue (no per-task identity) and is flagged ignored
            probe=(base.obs is not None
                   and base.obs.probe_every is not None),
            **cost)
        slot, works, _ = batch_slots(wls, dt, n_slots)
        scale = self._power_scale(base, n_slots, n, dt)
        return slot, works, powers, cfg, scale

    @staticmethod
    def _power_scale(scenario, n_slots, n, dt):
        failures, joins, resizes = resolve_fault_schedule(scenario)
        if not (failures or joins or resizes):
            return None
        scale = np.ones((n_slots, n))
        # fold up/down state and the resize fraction separately: a node
        # that fails at fraction 0.5 rejoins at 0.5, like the event engine
        events = sorted(
            [(t, node, "fail", 0.0) for t, node in failures]
            + [(t, node, "join", 1.0) for t, node in joins]
            + [(t, node, "resize", f) for t, node, f in resizes])
        up = np.ones(n, dtype=bool)
        frac = np.ones(n)
        for t, node, kind, value in events:
            if kind == "fail":
                up[node] = False
            elif kind == "join":
                up[node] = True
            else:  # resize; resolve_fault_schedule guarantees value > 0
                frac[node] = value
            # epsilon-guarded floor: 40.0 // 0.1 is 399 in floats, but the
            # event belongs to the slot containing t (slot 400)
            s = min(max(int(math.floor(t / dt + 1e-9)), 0), n_slots)
            scale[s:, node] = frac[node] if up[node] else 0.0
        return scale

    @staticmethod
    def _obs_extras(bm, i, cfg) -> dict:
        """Per-scenario telemetry payload from the engine's probe series, in the
        same shape the events backend exports (minus the Chrome trace and
        the hypergrid recursion levels the fluid model does not have)."""
        def clean(arr):
            return [float(x) if math.isfinite(x) else None for x in arr]
        times = (np.arange(cfg.n_slots) * cfg.dt).tolist()
        imb = bm.probe_imbalance[i]
        cross = bm.probe_crossover[i]
        fired = bm.probe_fires[i]
        probes = {
            "every": cfg.dt,
            "t": times,
            "node_load": [[float(x) for x in row]
                          for row in bm.probe_queue[i]],
            "imbalance_by_level": [[v] for v in clean(imb)],
            "fires": [int(f) for f in fired],
        }
        events = [
            {"t": times[k], "fired": bool(fired[k]),
             "imbalance": None if not math.isfinite(imb[k])
             else float(imb[k]),
             "crossover": None if not math.isfinite(cross[k])
             else float(cross[k]),
             "floor": cfg.floor,
             "bound": None if not math.isfinite(cross[k])
             else max(float(cross[k]), cfg.floor)}
            for k in range(cfg.n_slots)
        ]
        trigger = {
            "events": events,
            "summary": {
                "n_evals": cfg.n_slots if cfg.rebalance else 0,
                "n_fires": int(fired.sum()),
                "n_skips": (cfg.n_slots - int(fired.sum())
                            if cfg.rebalance else 0),
            },
        }
        return {"probes": probes, "trigger": trigger}

    def _result(self, scenario, bm, i, cfg, fault_counts, extra_ignored=(),
                admitted_work=None, extras=None):
        count = int(bm.completed[i])
        moved_units = float(bm.moved_units[i])
        n_failures, n_joins, n_resizes = fault_counts
        metrics = make_metrics(
            arrived=count, completed=count,
            makespan=float(bm.makespan[i]),
            mean_response=float(bm.mean_response[i]),
            p99_response=float(bm.p99_response[i]),
            moved_units=moved_units,
            moved_packets=moved_units * cfg.packets_per_unit,
            trigger_evals=cfg.n_slots if cfg.rebalance else 0,
            trigger_fires=int(bm.trigger_fires[i]),
            restarts=0,
            failures=n_failures,
            joins=n_joins,
            resizes=n_resizes,
            # the fluid model preempts nothing and never loses progress
            evictions=0, wasted_work=0.0,
            admitted_work=admitted_work)
        return RunResult(
            fingerprint=scenario.fingerprint(), backend=self.name,
            backend_options={
                "model": "fluid", "dt": cfg.dt, "n_slots": cfg.n_slots,
                **({"fifo_dispatch": True} if cfg.fifo_dispatch else {}),
                # spec fields the fluid model has no analogue for: the
                # trigger is evaluated every slot, migration is an instant
                # redistribution (cost via packets_per_step), the
                # positional rule runs flat (no hypergrid recursion), and
                # nothing is engine-random
                "ignored": ["policy.trigger_period", "cluster.bandwidth",
                            "cluster.d", "engine_seed"]
                + (["workload.m_tasks"]
                   if scenario.workload.m_tasks is not None else [])
                + list(extra_ignored),
            },
            metrics=metrics, extras=extras or {},
            scenario_name=scenario.name)

    def run(self, scenario, *, dt: float | None = None,
            fifo_dispatch: bool = False, device=None, **options):
        if options:
            raise TypeError(f"batched backend options: dt, fifo_dispatch "
                            f"and device only; got {sorted(options)}")
        return self.run_many([scenario], dt=dt, fifo_dispatch=fifo_dispatch,
                             device=device)[0]

    def run_many(self, scenarios: list[Scenario],
                 *, dt: float | None = None,
                 fifo_dispatch: bool = False,
                 device=None) -> list[RunResult]:
        """The whole sweep as ONE ``simulate_batch`` call, on the CUDA
        device unless ``device`` says otherwise."""
        if not scenarios:
            return []
        # one representative check suffices: compile enforces that the
        # rest differ only in seed/name, which eligibility never reads
        self.check(scenarios[0])
        dt = self.default_dt if dt is None else float(dt)
        if dt <= 0:
            raise BackendError(f"batched backend: dt must be > 0, got {dt}")
        slot, works, powers, cfg, scale = self.compile(
            scenarios, dt, fifo_dispatch=fifo_dispatch)
        bm = simulate_batch(slot, works, powers, cfg, power_scale=scale,
                            device=device)
        # one resolution for the whole batch: compile() enforced that the
        # scenarios share one fault schedule (only seed/name differ)
        fault_counts = tuple(
            len(evs) for evs in resolve_fault_schedule(scenarios[0]))
        extra_ignored = []
        if scenarios[0].workload.is_trace:
            wl = scenarios[0].workload.materialize(scenarios[0].seed)
            if isinstance(wl, TraceSchema) and wl.n_tiers > 1:
                # the fluid model has no task ordering, so tiers cannot
                # affect it — flagged, not rejected
                extra_ignored.append("workload trace priorities")
            if isinstance(wl, TraceSchema) and wl.ends_evicted.any():
                # end-mode eviction outcomes are per-task flags the fluid
                # model cannot count — flagged, not rejected
                extra_ignored.append(
                    "workload trace eviction outcomes (ends_evicted)")
        obs = scenarios[0].obs
        if obs is not None:
            if obs.trace:
                extra_ignored.append(
                    "obs.trace (no per-task identity in the fluid model)")
            if cfg.probe:
                extra_ignored.append(
                    "obs.probe_every cadence (fluid probes sample every "
                    "slot, i.e. every dt)")
        return [self._result(sc, bm, i, cfg, fault_counts, extra_ignored,
                             admitted_work=float(works[i].sum()),
                             extras={"obs": self._obs_extras(bm, i, cfg)}
                             if cfg.probe else None)
                for i, sc in enumerate(scenarios)]


# ---------------------------------------------------------------------------
# legacy — static paper simulator (core.simulator, section 5; host code)
# ---------------------------------------------------------------------------

@register_backend
class LegacyBackend(Backend):
    name = "legacy"

    def eligible(self, scenario):
        bad = _single_cluster_only(scenario)
        if bad is not None:
            return bad
        if not scenario.faults.empty:
            return ("the static paper simulator has no timeline; declare "
                    "faults on the events or batched backend")
        if scenario.policy.name != "psts":
            return (f"models exactly one full PSTS pass; policy "
                    f"{scenario.policy.name!r} is not expressible")
        if scenario.workload.is_trace:
            return ("samples its own workload realization; trace replay "
                    "needs the events or batched backend")
        if scenario.workload.dag is not None:
            return ("workload declares a task-dependency DAG; the static "
                    "snapshot has no timeline to gate releases on parent "
                    "completions — run on the events backend")
        return _unknown_policy_params(scenario)

    def run(self, scenario, **options):
        self.check(scenario)
        if options:
            raise TypeError(f"legacy backend takes no options: "
                            f"{sorted(options)}")
        cluster, wl_spec, pol = (scenario.cluster, scenario.workload,
                                 scenario.policy)
        powers = cluster.resolve_powers()
        n = int(powers.size)
        d = optimal_dim(n) if cluster.d is None else cluster.d
        if wl_spec.m_tasks is not None:
            m = wl_spec.m_tasks
        else:  # arrival count only — simulate() samples its own works
            rng = np.random.default_rng(scenario.seed)
            m = int(ARRIVAL_PROCESSES[wl_spec.process](
                wl_spec.horizon, rng, **wl_spec.params).shape[0])
        base = SimConfig()
        cost = {k: float(pol.params.get(k, getattr(base, k)))
                for k in _COST_KEYS if k != "floor"}
        cfg = SimConfig(
            n_nodes=n, d=d, m_tasks=m, work_dist=wl_spec.work_dist,
            work_mean=wl_spec.work_mean, packet_mean=wl_spec.packet_mean,
            powers=tuple(float(p) for p in powers), seed=scenario.seed,
            **cost)
        r = simulate(cfg)
        metrics = make_metrics(
            arrived=m, completed=m,
            makespan=r.makespan_after + r.overhead,
            migrations=r.moved_tasks,
            moved_packets=r.moved_packets,
            moved_units=r.moved_units,
            trigger_evals=1,
            trigger_fires=int(r.moved_tasks > 0),
            restarts=0, failures=0, joins=0, resizes=0,
            evictions=0, wasted_work=0.0)
        trig = CrossoverTrigger(
            embed(powers, d), p=cfg.p, q=cfg.q, t_task=cfg.t_task,
            packets_per_step=cfg.packets_per_step)
        extras = {
            "crossover": r.crossover,
            "arrival_crossover": trig.arrival_crossover(
                mean_work=cfg.work_mean, m_tasks=m,
                packets_per_task=cfg.packet_mean),
            "speedup": r.speedup,
            "overhead": r.overhead,
            "overhead_apriori": r.overhead_apriori,
            "makespan_before": r.makespan_before,
            "makespan_after": r.makespan_after,
            "imbalance_before": r.imbalance_before,
            "imbalance_after": r.imbalance_after,
            "residual": r.residual,
            "dims": list(r.dims),
        }
        return RunResult(
            fingerprint=scenario.fingerprint(), backend=self.name,
            backend_options={
                "model": "static-snapshot", "d": d,
                # unset cost constants keep SimConfig's paper-calibrated
                # absolute regime (p=0.2, ...), deliberately NOT the
                # PstsPolicy relative regime events/batched share — this
                # backend exists to reproduce the paper's Tables 6-7
                "cost_defaults": "SimConfig (paper-calibrated)",
                # the snapshot has no timeline: arrivals land at once and
                # the one PSTS pass runs unconditionally (no trigger, so
                # a hysteresis floor has nothing to gate)
                "ignored": ["workload arrival times",
                            "policy.trigger_period", "cluster.bandwidth",
                            "engine_seed"]
                + (["policy.params.floor"] if "floor" in pol.params
                   else [])
                + (["obs (static snapshot: no timeline to trace or probe)"]
                   if scenario.obs is not None else []),
            },
            metrics=metrics, extras=extras, scenario_name=scenario.name)
