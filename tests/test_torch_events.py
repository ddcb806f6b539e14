"""The port's discrete-event engine (``repro_torch.runtime.ClusterRuntime``)
and the lab's events backend, held against the JAX package's on the CPU.

Both packages run the same numpy operations in the same order, so equality
is exact: ``Metrics.summary()`` and ``work_census()`` of the engine for
every policy x workload x fault schedule, the events backend's
``RunResult.to_dict()``, and every eligibility reason the port can reach.
The only fields left out of a comparison are the wall-clock decision
latencies the tracer records (``WALL_CLOCK`` below). The invariant cases of
``tests/test_runtime.py`` run on the port as well.
"""

import json

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import lab as jlab  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.traces import Evictions, TraceSchema  # noqa: E402
from repro_torch import lab  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    POLICIES,
    ClusterRuntime,
    EventKind,
    EventQueue,
    Workload,
    make_policy,
    make_workload,
)
from repro_torch.runtime.runtime import InfeasibleTaskError  # noqa: E402

# "replica" registers itself on first use in both packages; register it in
# both now, so the policy lists (and the reasons that name them) agree
jrt.make_policy("replica")
make_policy("replica")

POWERS = np.array([3.0, 1.0, 7.0, 2.0, 5.0, 9.0, 4.0, 6.0])
LAB_POWERS = (3.0, 1.0, 7.0, 2.0, 5.0, 9.0, 4.0, 6.0,
              2.0, 8.0, 1.0, 5.0, 3.0, 6.0, 4.0, 7.0)
WORKLOADS = {
    "poisson": dict(rate=3.0, work_mean=5.0),
    "bursty": dict(rate_lo=0.5, rate_hi=10.0, sojourn_lo=15.0,
                   sojourn_hi=5.0, work_mean=5.0),
    "diurnal": dict(rate_mean=3.0, amplitude=0.8, period=40.0,
                    work_mean=5.0),
}
# failures, joins and resizes: two nodes fail, one rejoins, one shrinks,
# one shrinks while down and comes back at the new rate
CHURN = dict(failures=[(10.0, 1), (25.0, 5), (30.0, 3)],
             joins=[(40.0, 1), (55.0, 3)],
             resizes=[(15.0, 2, 0.5), (35.0, 3, 0.25), (45.0, 6, 2.0)])
# the tracer's wall-clock decision latencies: the only values that cannot
# equal the JAX package's (``n`` and ``sampled`` are counts, compared)
WALL_CLOCK = ("mean_us", "p99_us", "p999_us", "max_us")


def _bursty(pkg, seed=0, horizon=80.0):
    return pkg.make_workload("bursty", horizon=horizon, seed=seed,
                             rate_lo=0.5, rate_hi=10.0, sojourn_lo=15.0,
                             sojourn_hi=5.0, work_mean=5.0)


def _run(policy, wl, powers, *, failures=(), joins=(), resizes=(), **kw):
    rt = ClusterRuntime(powers, policy, **kw)
    return rt.run(wl, failures=failures, joins=joins, resizes=resizes)


def _scrub(obs):
    """An ``extras["obs"]`` payload with the wall-clock latencies (the
    ``WALL_CLOCK`` stats of ``decision_stats``, also under the Chrome
    trace's ``otherData``, and the registry's ``sched_decision_latency_us``
    gauge that mirrors them) set to None."""
    obs = json.loads(json.dumps(obs))

    def clean(stats):
        for s in stats.values():
            for k in WALL_CLOCK:
                s[k] = None
    if "decision_stats" in obs:
        clean(obs["decision_stats"])
        clean(obs["chrome_trace"]["otherData"]["decision_stats"])
    lat = obs.get("metrics", {}).get("sched_decision_latency_us")
    if lat is not None:
        lat["samples"] = {k: None for k in lat["samples"]}
    return obs


# ---------------------------------------------------------------------------
# the engine, exactly equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faults", ["none", "churn"])
@pytest.mark.parametrize("process", sorted(WORKLOADS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_engine_matches_reference(policy, process, faults):
    assert sorted(POLICIES) == sorted(jrt.POLICIES)
    sched = CHURN if faults == "churn" else {}
    out = []
    for pkg in (jrt, prt):
        wl = pkg.make_workload(process, horizon=60.0, seed=3,
                               **WORKLOADS[process])
        rt = pkg.ClusterRuntime(POWERS, policy, seed=7, trigger_period=1.0,
                                bandwidth=32.0)
        m = rt.run(wl, **sched)
        out.append((m.summary(), rt.work_census(), rt.census(),
                    [(t.tid, t.node, t.t_start, t.t_finish, t.restarts,
                      t.migrations, t.placements)
                     for t in rt.tasks.values()]))
    (want, want_census, want_live, want_tasks), (got, census, live, tasks) \
        = out
    assert got == want
    assert census == want_census
    assert live == want_live
    assert tasks == want_tasks
    assert got["completed"] == got["arrived"] > 0
    if faults == "churn":
        assert got["failures"] == 3 and got["joins"] == 2


@pytest.mark.parametrize("policy", ["psts", "jsq"])
def test_session_micro_steps_match_reference_run(policy):
    """The session verbs (schedule_workload, bounded ``advance``, ``drain``)
    compose to the same metrics as the JAX package's one-shot ``run``."""
    wl = _bursty(prt, seed=4)
    rt = ClusterRuntime(POWERS, policy, seed=1, trigger_period=0.5)
    rt.schedule_workload(wl, failures=[(12.0, 4)], joins=[(30.0, 4)])
    steps = 0
    while rt.pending_work():
        steps += rt.advance(until=rt._now + 3.0, max_events=50)
    rt.drain()
    ref = jrt.ClusterRuntime(POWERS, policy, seed=1, trigger_period=0.5)
    want = ref.run(_bursty(jrt, seed=4), failures=[(12.0, 4)],
                   joins=[(30.0, 4)])
    assert steps > 0
    assert rt.metrics.summary() == want.summary()
    assert rt.work_census() == ref.work_census()


def test_live_submit_matches_reference():
    """Tasks fed one by one through ``submit`` (arrivals on the absolute
    trigger grid) give the JAX package's metrics for the same feed."""
    wl = _bursty(prt, seed=6, horizon=40.0)
    out = []
    for pkg in (jrt, prt):
        rt = pkg.ClusterRuntime(POWERS, "psts", seed=2, trigger_period=1.0)
        for i in range(wl.m):
            rt.advance(until=float(wl.t_arrive[i]))
            rt.submit(pkg.Task(tid=i, t_arrive=float(wl.t_arrive[i]),
                               work=float(wl.works[i]),
                               packets=float(wl.packets[i])))
        out.append(rt.drain().summary())
    assert out[1] == out[0]
    assert out[1]["completed"] == wl.m


def test_event_queue_tie_order_matches_reference():
    rng = np.random.default_rng(0)
    times = rng.integers(0, 5, size=200).astype(float)
    kinds = rng.integers(0, len(EventKind), size=200)
    pops = []
    for pkg in (jrt, prt):
        q = pkg.EventQueue()
        for i, (t, k) in enumerate(zip(times, kinds)):
            q.push(t, pkg.EventKind(int(k)), i)
        got = q.extract(pkg.EventKind.EVICTION, lambda p: p % 2 == 0)
        order = []
        while q:
            ev = q.pop()
            order.append((ev.time, int(ev.kind), ev.payload))
        pops.append(([ev.payload for ev in got], order))
    assert pops[1] == pops[0]
    assert [k.name for k in EventKind] == [k.name for k in jrt.EventKind]
    q = EventQueue()
    q.push(1.0, EventKind.ARRIVAL)
    q.push(1.0, EventKind.NODE_FAIL)
    assert q.pending(EventKind.ARRIVAL, EventKind.NODE_FAIL) == 2
    assert q.pop().kind == EventKind.NODE_FAIL  # failures first at a tie


# ---------------------------------------------------------------------------
# invariants (tests/test_runtime.py's cases, on the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_conservation_under_failures(policy):
    wl = _bursty(prt, seed=2)
    rt = ClusterRuntime(POWERS, policy, seed=7, trigger_period=1.0,
                        bandwidth=32.0)
    m = rt.run(wl, failures=[(10.0, 1), (25.0, 5)], joins=[(40.0, 1)])
    assert m.arrived == wl.m
    assert m.completed == wl.m, "every task completes exactly once"
    assert len(m.responses) == wl.m
    assert sorted(rt.tasks) == list(range(wl.m))
    assert all(t.t_finish is not None for t in rt.tasks.values())
    assert all(r >= 0.0 for r in m.responses)
    assert m.failures == 2 and m.joins == 1
    census = rt.work_census()
    assert census["conservation_gap"] < 1e-9
    assert census["completed"] == pytest.approx(census["admitted"])


def test_migrated_tasks_counted_once():
    wl = _bursty(prt, seed=5)
    rt = ClusterRuntime(POWERS, "psts", seed=0, trigger_period=1.0,
                        policy_kwargs={"floor": 0.02, "p": 1e-4})
    m = rt.run(wl)
    assert m.migrations > 0, "regime should exercise migrations"
    assert m.completed == wl.m
    assert m.moved_packets == pytest.approx(
        sum(rt.tasks[t.tid].packets * t.migrations
            for t in rt.tasks.values()))


def test_nonpreemption_running_tasks_never_move():
    wl = _bursty(prt, seed=3)
    rt = ClusterRuntime(POWERS, "psts", seed=1, trigger_period=0.5,
                        policy_kwargs={"floor": 0.02, "p": 1e-4})
    m = rt.run(wl, failures=[(15.0, 2)], joins=[(30.0, 2)])
    assert m.migrations > 0
    for task in rt.tasks.values():
        if task.restarts:
            continue  # failure restarts are the one sanctioned exception
        assert all(t <= task.t_start + 1e-9 for t, _ in task.placements), \
            f"task {task.tid} was moved after starting service"
        assert task.node == task.placements[-1][1]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_total_outage_then_rejoin(policy):
    wl = Workload(t_arrive=np.array([0.0, 1.0]),
                  works=np.array([4.0, 4.0]), packets=np.ones(2))
    m = _run(policy, wl, np.ones(2),
             failures=[(0.5, 0), (0.5, 1)], joins=[(3.0, 0)])
    assert m.completed == 2
    assert m.restarts >= 1


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_arrival_during_total_outage_released_by_other_node(policy):
    wl = Workload(t_arrive=np.array([5.0]), works=np.array([4.0]),
                  packets=np.ones(1))
    m = _run(policy, wl, np.ones(2),
             failures=[(1.0, 0), (1.0, 1)], joins=[(10.0, 1)])
    assert m.completed == 1


def test_failure_restart_is_flagged_not_preempted():
    wl = Workload(t_arrive=np.array([0.0, 0.0]),
                  works=np.array([10.0, 10.0]),
                  packets=np.array([1.0, 1.0]))
    rt = ClusterRuntime(np.array([1.0, 1.0]), "jsq", d=1)
    m = rt.run(wl, failures=[(2.0, 1)])
    assert m.completed == 2
    assert m.restarts == 1
    restarted = [t for t in rt.tasks.values() if t.restarts]
    assert len(restarted) == 1
    assert restarted[0].placements[-1][1] == 0


def test_resize_banks_progress_and_keeps_conservation():
    wl = Workload(t_arrive=np.array([0.0]), works=np.array([10.0]),
                  packets=np.ones(1))
    rt = ClusterRuntime(np.array([1.0]), "jsq", d=1)
    m = rt.run(wl, resizes=[(4.0, 0, 2.0)])
    # 4 units at rate 1, the other 6 at rate 2
    assert m.completed == 1 and m.resizes == 1
    assert rt.tasks[0].t_finish == pytest.approx(7.0)
    assert rt.work_census()["conservation_gap"] == 0.0


def test_trigger_floor_prevents_thrashing():
    wl = _bursty(prt, seed=9, horizon=120.0)
    kw = {"p": 1e-6, "q": 1e-7, "t_task": 1e-7}  # overhead ~ 0
    fires = {}
    for floor in [0.0, 0.5, 1e9]:
        rt = ClusterRuntime(POWERS, "psts", seed=2, trigger_period=0.5,
                            policy_kwargs={**kw, "floor": floor})
        m = rt.run(wl)
        assert m.completed == wl.m
        fires[floor] = m.trigger_fires
    assert fires[0.0] > 0, "free trigger should thrash in this regime"
    assert fires[1e9] == 0, "floor above any imbalance suppresses every fire"
    assert fires[0.0] >= fires[0.5] >= fires[1e9]


def test_registry_contents():
    for name in ["random", "round_robin", "jsq", "arrival_only", "psts"]:
        assert name in POLICIES
        assert make_policy(name).name == name
    with pytest.raises(ValueError):
        make_policy("nope")
    assert make_policy("replica").uses_trigger


def test_load_aware_beats_random():
    wl = _bursty(prt, seed=11, horizon=120.0)
    means = {pol: _run(pol, wl, POWERS, seed=3).mean_response
             for pol in ["random", "jsq", "psts"]}
    assert means["jsq"] < means["random"]
    assert means["psts"] < means["random"]


def test_trigger_not_armed_for_static_policies():
    m = _run("jsq", _bursty(prt, seed=4), POWERS, trigger_period=1.0)
    assert m.trigger_evals == 0 and m.trigger_fires == 0


def test_deprecated_spellings_warn_and_match():
    wl = _bursty(prt, seed=8, horizon=40.0)
    with pytest.warns(DeprecationWarning, match="run_policy"):
        m = prt.run_policy("jsq", wl, POWERS, seed=1)
    assert m.summary() == ClusterRuntime(POWERS, "jsq", seed=1).run(
        wl).summary()
    rt = ClusterRuntime(POWERS, "psts", trigger_period=1.0)
    rt.schedule_workload(wl)
    with pytest.warns(DeprecationWarning, match="step_until"):
        rt.step_until(10.0)
    task = rt.queued_tasks()[0] if rt.queued_tasks() else None
    if task is not None:
        rt.withdraw(task)
        with pytest.warns(DeprecationWarning, match="inject"):
            rt.inject(task, 11.0)
    rt.drain()
    assert rt.metrics.completed == wl.m
    assert rt.work_census()["conservation_gap"] < 1e-9


def test_what_waits_for_later_slices_says_so():
    rt = ClusterRuntime(POWERS, "psts")
    with pytest.raises(NotImplementedError, match="serve slice"):
        rt.open_session()
    # one class for every constraint diagnostic, a ValueError as in the
    # JAX package: the traces package re-exports the engine's
    from repro_torch import traces
    assert issubclass(InfeasibleTaskError, ValueError)
    assert traces.InfeasibleTaskError is InfeasibleTaskError
    with pytest.raises(ValueError, match="node attr"):
        ClusterRuntime(POWERS, "psts", node_attrs={"rack": (0, 1)})


def test_submit_guards():
    rt = ClusterRuntime(POWERS, "jsq")
    rt.submit(prt.Task(tid=0, t_arrive=0.0, work=1.0, packets=1.0))
    rt.advance(until=1.0)
    with pytest.raises(ValueError, match="already admitted"):
        rt.submit(prt.Task(tid=0, t_arrive=1.0, work=1.0, packets=1.0))
    with pytest.raises(ValueError, match="cannot submit"):
        rt.submit(prt.Task(tid=1, t_arrive=0.0, work=1.0, packets=1.0),
                  0.5)
    rt2 = ClusterRuntime(POWERS, "jsq")
    with pytest.raises(RuntimeError, match="budget"):
        rt2.run(_bursty(prt, seed=1), max_events=10)


# ---------------------------------------------------------------------------
# the events backend through repro_torch.lab
# ---------------------------------------------------------------------------

def _scenario(pkg, **overrides):
    fields = dict(
        cluster=pkg.ClusterSpec(powers=LAB_POWERS, bandwidth=256.0),
        workload=pkg.WorkloadSpec(process="poisson", horizon=60.0,
                                  work_mean=6.0, params={"rate": 6.0}),
        policy=pkg.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.1}),
        seed=0)
    fields.update(overrides)
    return pkg.Scenario(**fields)


def _both(**overrides):
    sc = _scenario(jlab, **overrides)
    return sc, lab.Scenario.from_json(sc.to_json())


FAULTS = dict(failures=((20.0, 5), (22.0, 9)), joins=((40.0, 5),),
              resizes=((10.0, 2, 0.5),))


@pytest.mark.parametrize("case", [
    dict(),
    dict(faults=FAULTS),
    dict(policy=("jsq", {})),
    dict(obs=dict(trace=True, probe_every=2.0)),
    dict(faults=FAULTS, obs=dict(trace=True, ring=256, probe_every=1.0,
                                 metrics=True, anomaly=True)),
    dict(workload=dict(m_tasks=50)),
], ids=["plain", "faults", "jsq", "obs", "faults-obs-ops", "m_tasks"])
def test_events_backend_run_matches_reference(case):
    overrides = {}
    if "faults" in case:
        overrides["faults"] = jlab.FaultSpec(**case["faults"])
    if "policy" in case:
        name, params = case["policy"]
        overrides["policy"] = jlab.PolicySpec(name, params=params)
    if "obs" in case:
        overrides["obs"] = jlab.ObsSpec(**case["obs"])
    if "workload" in case:
        overrides["workload"] = jlab.WorkloadSpec(
            process="poisson", horizon=60.0, work_mean=6.0,
            params={"rate": 6.0}, **case["workload"])
    jsc, sc = _both(**overrides)
    want = jlab.run(jsc).to_dict()
    got = lab.run(sc).to_dict()
    assert got["backend"] == want["backend"] == "events"
    if "obs" in want["extras"]:
        want["extras"]["obs"] = _scrub(want["extras"]["obs"])
        got["extras"]["obs"] = _scrub(got["extras"]["obs"])
    assert got == want
    json.dumps(got, allow_nan=False)


def test_events_backend_takes_no_device():
    sc = _scenario(lab)
    with pytest.raises(TypeError, match="takes no options"):
        lab.run(sc, backend="events", device="cpu")
    with pytest.raises(TypeError, match="takes no options"):
        jlab.run(_scenario(jlab), backend="events", dt=1.0)


class _FederationLike:
    is_federation = True


@pytest.mark.parametrize("overrides", [
    dict(policy=jlab.PolicySpec("nope")),
    dict(policy=jlab.PolicySpec("psts", params={"flor": 0.9})),
    dict(policy=jlab.PolicySpec("jsq", params={"floor": 0.1})),
    dict(faults=jlab.FaultSpec(failures=((10.0, 99),))),
    dict(faults=jlab.FaultSpec(resizes=((10.0, -1, 0.5),))),
    dict(workload=jlab.WorkloadSpec(trace_path="/nonexistent/trace.csv")),
    dict(faults=jlab.FaultSpec(joins=((10.0, 2),))),
    dict(),
], ids=["unknown-policy", "typo", "foreign-param", "range", "resize-range",
        "trace", "join-only", "ok"])
def test_events_eligibility_reasons_match(overrides):
    jsc, sc = _both(**overrides)
    want = jlab.get_backend("events").eligible(jsc)
    assert lab.get_backend("events").eligible(sc) == want
    if want is not None:
        with pytest.raises(lab.BackendError, match="backend 'events'"):
            lab.run(sc)


def test_federation_like_spec_is_refused_everywhere():
    for name in ("events", "legacy", "batched"):
        want = jlab.get_backend(name).eligible(_FederationLike())
        assert lab.get_backend(name).eligible(_FederationLike()) == want
        assert "'federated' backend" in want


@pytest.mark.parametrize("dag", [
    {"kind": "chain"},
    {"kind": "random", "p": 0.3},
    {"kind": "chain", "nonsense": 1},
    {"edges": [[1, 0], [2, 1]]},
    {"edges": [[5000, 0]]},
], ids=["chain", "random", "bad-param", "edges", "edges-out-of-range"])
def test_dag_workload_waits_for_the_graphs_slice(dag):
    """The realized DAG's eligibility on every backend equals the JAX
    package's: events takes a realizable one and gives the generator's
    diagnostic for the rest; batched and legacy refuse it."""
    jsc, sc = _both(workload=jlab.WorkloadSpec(
        process="poisson", horizon=60.0, work_mean=6.0,
        params={"rate": 6.0}, dag=dag))
    for name in ("events", "batched", "legacy"):
        want = jlab.get_backend(name).eligible(jsc)
        assert lab.get_backend(name).eligible(sc) == want, name
    reason = lab.get_backend("events").eligible(sc)
    if "nonsense" in dag or [5000, 0] in dag.get("edges", []):
        assert reason.startswith("workload dag unrealizable")
    else:
        assert reason is None


def test_trace_path_replay_matches_reference():
    from pathlib import Path
    trace = Path(__file__).parent / "data" / "tiny_trace.csv"
    jsc, sc = _both(workload=jlab.WorkloadSpec(trace_path=str(trace),
                                               horizon=None))
    got = lab.run(sc).to_dict()
    assert got == jlab.run(jsc).to_dict()
    assert got["metrics"]["completed"] == 8


# ---------------------------------------------------------------------------
# auto-dispatch (tests/test_lab.py's cases, on the port)
# ---------------------------------------------------------------------------

def test_sweep_small_or_nonuniform_stays_on_events():
    small = lab.sweep(base=_scenario(lab), grid={"seed": range(3)})
    assert [r.backend for r in small] == ["events"] * 3
    mixed = lab.sweep(base=_scenario(lab, policy=lab.PolicySpec("psts")),
                      grid={"seed": range(5),
                            "policy.name": ["arrival_only", "psts"]},
                      batch_threshold=4, device="cpu")
    assert {r.backend for r in mixed} == {"events"}
    jsmall = jlab.sweep(base=_scenario(jlab), grid={"seed": range(3)})
    assert [r.to_dict() for r in small] == [r.to_dict() for r in jsmall]


def test_sweep_ineligible_policy_falls_back_to_events():
    res = lab.sweep(base=_scenario(lab, policy=lab.PolicySpec("jsq")),
                    grid={"seed": range(10)}, batch_threshold=8,
                    device="cpu")
    assert {r.backend for r in res} == {"events"}


def test_sweep_large_uniform_goes_batched_with_device():
    res = lab.sweep(base=_scenario(lab), grid={"seed": range(8)},
                    device="cpu")
    assert {r.backend for r in res} == {"batched"}


def test_stale_policy_params_fail_fast_with_reason():
    base = _scenario(lab)
    bad = base.updated({"policy.name": "jsq"})
    with pytest.raises(lab.BackendError, match="floor"):
        lab.sweep([base.updated({"policy.name": "psts"}), bad])


def test_events_vs_batched_equivalence_smoke():
    sc = _scenario(lab, workload=lab.WorkloadSpec(
        process="poisson", horizon=100.0, work_mean=6.0,
        params={"rate": 6.0}))
    ev = lab.run(sc, backend="events")
    ba = lab.run(sc, backend="batched", device="cpu")
    assert ev["completed"] == ba["completed"]
    rel = abs(ev["mean_response"] - ba["mean_response"]) / ev["mean_response"]
    assert rel < 0.5, (ev["mean_response"], ba["mean_response"])


def test_obs_changes_no_metric_on_events():
    base = _scenario(lab)
    on = _scenario(lab, obs=lab.ObsSpec(trace=True, probe_every=2.0,
                                        metrics=True))
    assert base.fingerprint() == on.fingerprint()
    r0, r1 = lab.run(base), lab.run(on)
    assert r0.metrics == r1.metrics
    assert "obs" not in r0.extras and "obs" in r1.extras
    json.dumps(r1.to_dict(), allow_nan=False)


# ---------------------------------------------------------------------------
# conformance (tests/test_conformance.py's cases, on the port). Trace
# workloads come from the JAX package's TraceSchema: plain numpy fields
# (priorities, evictions, end-mode flags) the engine reads duck-typed, so
# both engines replay the very same object.
# ---------------------------------------------------------------------------

CHURN_POWERS = (3.0, 1.0, 4.0, 2.0)


def _uniform_scenario(seed: int) -> lab.Scenario:
    rng = np.random.default_rng(seed)
    cluster = lab.ClusterSpec(n_nodes=int(rng.integers(2, 9)),
                              power_seed=int(rng.integers(0, 16)),
                              bandwidth=256.0)
    work_mean = float(rng.uniform(2.0, 6.0))
    utilization = float(rng.uniform(0.3, 0.75))
    rate = utilization * float(cluster.resolve_powers().sum()) / work_mean
    return lab.Scenario(
        cluster=cluster,
        workload=lab.WorkloadSpec(
            process="poisson", horizon=50.0, work_dist="uniform",
            work_mean=work_mean, params={"rate": rate}),
        policy=lab.PolicySpec(
            "psts" if rng.integers(0, 2) else "arrival_only",
            trigger_period=1.0),
        seed=int(rng.integers(0, 1 << 31)))


@pytest.mark.parametrize("seed", [3, 11, 42, 1234])
def test_events_vs_batched_makespan_envelope(seed):
    sc = _uniform_scenario(seed)
    e = lab.run(sc, backend="events")
    b = lab.run(sc, backend="batched", dt=1.0, device="cpu")
    assert e["arrived"] == b["arrived"]
    assert e["completed"] == e["arrived"]
    assert b["completed"] == b["arrived"]
    assert abs(e["makespan"] - b["makespan"]) <= 0.15 * e["makespan"] + 2.0
    assert b["mean_response"] <= 2.0 * e["mean_response"] + 2.0
    assert e.to_dict() == jlab.run(jlab.Scenario.from_json(sc.to_json()),
                                   backend="events").to_dict()


def _churn_inputs(seed: int):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(5, 60))
    k = int(rng.integers(0, m))
    trace = TraceSchema(
        t_arrive=np.sort(rng.uniform(0.0, 30.0, m)),
        works=rng.uniform(0.5, 4.0, m),
        packets=rng.uniform(1.0, 8.0, m),
        priority=rng.integers(0, 3, m).astype(np.int32),
        evictions=Evictions(rng.integers(0, m, k),
                            rng.uniform(0.0, 40.0, k)),
        ends_evicted=rng.random(m) < 0.1)
    nodes = rng.permutation(len(CHURN_POWERS))[:int(rng.integers(0, 3))]
    failures, joins = [], []
    for nd in nodes:
        t_fail = float(rng.uniform(0.0, 25.0))
        failures.append((t_fail, int(nd)))
        joins.append((t_fail + float(rng.uniform(1.0, 15.0)), int(nd)))
    resizes = [(float(rng.uniform(0.0, 35.0)),
                int(rng.integers(0, len(CHURN_POWERS))),
                float(rng.uniform(0.3, 2.0)))
               for _ in range(int(rng.integers(0, 3)))]
    return trace, failures, joins, resizes


@pytest.mark.parametrize("seed", [0, 7, 19, 101, 555])
def test_conservation_under_churn_matches_reference(seed):
    """Priorities, eviction replay, end-mode evictions, failures, joins and
    resizes: the work census at every cut instant and the final metrics
    equal the reference's, and work is conserved throughout."""
    trace, failures, joins, resizes = _churn_inputs(seed)
    runs = []
    for pkg in (jrt, prt):
        rt = pkg.ClusterRuntime(CHURN_POWERS, "psts", trigger_period=1.0,
                                seed=0, policy_kwargs={"floor": 0.05})
        rt.schedule_workload(trace, failures=failures, joins=joins,
                             resizes=resizes)
        cuts = []
        for cut in (5.0, 12.0, 21.0, 33.0):
            rt.advance(until=cut)
            cuts.append(rt.work_census(cut))
        rt.advance(until=1e9)
        runs.append((rt, cuts))
    (ref, ref_cuts), (rt, cuts) = runs
    assert cuts == ref_cuts
    assert rt.metrics.summary() == ref.metrics.summary()
    assert rt.work_census() == ref.work_census()
    for c in cuts:
        assert c["conservation_gap"] <= 1e-6 * max(c["admitted"], 1.0)
    m = rt.metrics
    assert m.completed == m.arrived == trace.m
    end = rt.work_census()
    assert end["in_flight"] == pytest.approx(0.0, abs=1e-9)
    assert end["completed"] == pytest.approx(float(trace.works.sum()))
    assert sum(t.evictions for t in rt.tasks.values()) == m.evictions
    assert sum(t.restarts for t in rt.tasks.values()) == m.restarts


@pytest.mark.parametrize("case", [
    dict(t_arrive=[0.0], works=[4.0], packets=[1.0],
         evictions=([0], [2.0]), powers=(1.0,),
         want=dict(completed=1, evictions=1, wasted_work=2.0, makespan=6.0)),
    dict(t_arrive=[0.0], works=[1.0], packets=[1.0],
         evictions=([0], [5.0]), powers=(1.0,),
         want=dict(completed=1, evictions=0, wasted_work=0.0, makespan=1.0)),
    dict(t_arrive=[0.0], works=[2.0], packets=[1.0],
         evictions=([0], [2.0]), powers=(1.0,),
         want=dict(completed=1, evictions=0, makespan=2.0)),
    dict(t_arrive=[0.0, 0.0], works=[1.0, 1.0], packets=[1.0, 1.0],
         ends_evicted=[True, False], powers=(1.0, 1.0),
         want=dict(completed=2, evictions=1, wasted_work=0.0)),
    dict(t_arrive=[0.0], works=[8.0], packets=[1.0], powers=(2.0,),
         resizes=[(2.0, 0, 0.5)],
         want=dict(makespan=6.0, resizes=1, restarts=0, mean_wait=0.0)),
    dict(t_arrive=[0.0], works=[8.0], packets=[1.0], powers=(2.0,),
         resizes=[(2.0, 0, 0.0)], joins=[(3.0, 0)],
         want=dict(failures=1, restarts=1, makespan=7.0)),
], ids=["evict-requeue", "evict-finished", "completion-beats-evict",
        "end-mode", "resize", "zero-resize"])
def test_eviction_and_resize_cases_match_reference(case):
    case = dict(case)
    powers, want = case.pop("powers"), case.pop("want")
    sched = {k: case.pop(k) for k in ("resizes", "joins") if k in case}
    if "evictions" in case:
        case["evictions"] = Evictions(*case["evictions"])
    if "ends_evicted" in case:
        case["ends_evicted"] = np.array(case["ends_evicted"])
    trace = TraceSchema(**case)
    out = [pkg.ClusterRuntime(powers, "jsq", trigger_period=0.0)
           .run(trace, **sched).summary() for pkg in (jrt, prt)]
    assert out[1] == out[0]
    for k, v in want.items():
        assert out[1][k] == pytest.approx(v), k


def test_zero_resize_is_a_failure_on_every_backend():
    sc = lab.Scenario(
        cluster=lab.ClusterSpec(powers=(2.0, 2.0)),
        workload=lab.WorkloadSpec(process="poisson", horizon=8.0,
                                  params={"rate": 1.0}),
        policy=lab.PolicySpec("arrival_only"),
        faults=lab.FaultSpec(failures=((1.0, 1),),
                             joins=((2.0, 1), (4.0, 1)),
                             resizes=((3.0, 1, 0.0),)))
    failures, joins, resizes = lab.resolve_fault_schedule(sc)
    assert (3.0, 1) in failures and resizes == ()
    backend = lab.get_backend("batched")
    assert backend.eligible(sc) is None
    scale = backend._power_scale(sc, n_slots=8, n=2, dt=1.0)
    np.testing.assert_allclose(scale[3, 1], 0.0)
    np.testing.assert_allclose(scale[4:, 1], 1.0)
    e = lab.run(sc, backend="events")
    assert e["completed"] == e["arrived"]
    assert e["failures"] == 2 and e["joins"] == 2
