"""The port's scheduler service (``repro_torch.serve``) and its ``online`` lab
backend, held against the JAX package's ``repro.serve`` on the CPU.

The cases of ``tests/test_online.py`` run on the port: the session
lifecycle, streaming == offline replay under churn (arrival-paced,
fixed-step and in tiny micro-steps), the decision stream, the task sources,
the operator verbs and the deprecation shims; its two CLI cases are in
``tests/test_torch_cli.py``. Where both packages can run the same inputs,
the port's results are held against the reference's exactly: the decision
stream element for element (``seq``, ``kind``, ``t``, task, node, ``src``,
``dst``, ``info``) and ``Metrics.summary()`` as JSON, byte for byte. The
online backend equals the port's own events backend byte for byte too,
also on the bundled Google excerpt replayed with its constraints, requeue
evictions and machine events. The ops-plane cases of ``tests/test_ops.py``
that need the service (scrapes of a live service, alerts on the decision
stream) run here as well.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (one torch thread a worker)

import io
import json
import warnings
from pathlib import Path

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.serve as serve  # noqa: E402
from repro import lab as jlab  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro import traces as jtraces  # noqa: E402
from repro_torch import lab  # noqa: E402
from repro_torch import traces as ptraces  # noqa: E402
from repro_torch.obs import attach_collector, parse_openmetrics  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ClusterRuntime,
    make_workload,
    run_policy,
)
from repro_torch.runtime.runtime import Task  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Decision,
    DecisionLog,
    IterableSource,
    JsonlSource,
    SchedulerService,
    Session,
    TaskSubmit,
    WorkloadSource,
)

from _hypothesis_compat import given, settings, st  # noqa: E402

STREAM_PROFILE = dict(max_examples=12, deadline=None, derandomize=True)
POWERS = np.array([3.0, 1.0, 7.0, 2.0])  # tests/test_conformance.py's
DATA = Path(__file__).resolve().parents[1] / "benchmarks" / "data"
EXCERPT = DATA / "google_excerpt_10k.csv.gz"
# the packages side by side: (runtime class, traces, serve, lab)
PORT = (ClusterRuntime, ptraces, serve, lab)
REF = (jrt.ClusterRuntime, jtraces, jserve, jlab)


def _churn_inputs(pkg, seed: int):
    """``tests/test_conformance.py::_churn_inputs`` for either package: a
    random trace (tiers, requeue evictions, traces that end evicted) and a
    fault schedule, derived from one integer."""
    traces = pkg[1]
    rng = np.random.default_rng(seed)
    m = int(rng.integers(5, 60))
    k = int(rng.integers(0, m))
    trace = traces.TraceSchema(
        t_arrive=np.sort(rng.uniform(0.0, 30.0, m)),
        works=rng.uniform(0.5, 4.0, m),
        packets=rng.uniform(1.0, 8.0, m),
        priority=rng.integers(0, 3, m).astype(np.int32),
        evictions=traces.Evictions(rng.integers(0, m, k),
                                   rng.uniform(0.0, 40.0, k)),
        ends_evicted=rng.random(m) < 0.1)
    nodes = rng.permutation(len(POWERS))[:int(rng.integers(0, 3))]
    failures, joins = [], []
    for nd in nodes:
        t_fail = float(rng.uniform(0.0, 25.0))
        failures.append((t_fail, int(nd)))
        joins.append((t_fail + float(rng.uniform(1.0, 15.0)), int(nd)))
    resizes = [(float(rng.uniform(0.0, 35.0)),
                int(rng.integers(0, len(POWERS))),
                float(rng.uniform(0.3, 2.0)))
               for _ in range(int(rng.integers(0, 3)))]
    return trace, failures, joins, resizes


def _psts(pkg=PORT):
    """The conformance suite's reference runtime (same ctor as offline)."""
    return pkg[0](POWERS, "psts", trigger_period=1.0, seed=0,
                  policy_kwargs={"floor": 0.05})


def _offline(pkg, trace, failures=(), joins=(), resizes=()):
    rt = _psts(pkg)
    rt.run(trace, failures=failures, joins=joins, resizes=resizes)
    return rt


def _online(pkg, trace, failures=(), joins=(), resizes=(), *,
            step: float | None = None):
    """Stream the trace through a service: arrival-paced micro-steps by
    default (one admission batch per step), or fixed-width steps."""
    svc = pkg[2].SchedulerService(_psts(pkg))
    svc.rt.schedule_faults(failures=failures, joins=joins, resizes=resizes)
    src = svc.attach(pkg[2].WorkloadSource(trace))
    if step is None:
        while not src.exhausted:
            svc.advance(until=src.next_time)
    else:
        while svc.session.pending_sources:
            svc.advance(until=svc.now + step)
    svc.drain()
    svc.close()
    return svc


def _assert_identical(off, on) -> None:
    assert on.metrics.summary() == off.metrics.summary()
    assert on.work_census() == off.work_census()


def _stream(log):
    return [(d.seq, d.kind, d.t, d.tid, d.node, d.src, d.dst, d.info)
            for d in log]


def _assert_equals_reference(svc, jsvc) -> None:
    """The port's service against the reference's: the decision stream
    element for element, the counts, and the summary byte for byte."""
    assert _stream(svc.log) == _stream(jsvc.log)
    assert svc.log.counts == jsvc.log.counts
    assert json.dumps(svc.summary()) == json.dumps(jsvc.summary())
    assert svc.rt.work_census() == jsvc.rt.work_census()


# ---------------------------------------------------------------------------
# session lifecycle: open / feed / submit / advance / drain / close
# ---------------------------------------------------------------------------

def test_open_session_lifecycle():
    wl = make_workload("poisson", horizon=20.0, seed=0, rate=2.0)
    rt = ClusterRuntime((3.0, 1.0, 7.0, 2.0), "jsq")
    s = rt.open_session()
    assert isinstance(s, Session)
    s.feed(WorkloadSource(wl))
    n = s.advance(until=10.0)
    assert n > 0
    assert 0 < rt.metrics.arrived < wl.m, "micro-step admits only up to t"
    s.submit(TaskSubmit(t=10.5, work=2.0, packets=1.0))
    m = s.drain()
    assert m.completed == m.arrived == wl.m + 1
    assert s.close() is rt.metrics
    s.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        s.advance(until=1e9)
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(TaskSubmit(t=99.0, work=1.0))
    # the same session in the JAX package gives the same summary
    jwl = jrt.make_workload("poisson", horizon=20.0, seed=0, rate=2.0)
    jr = jrt.ClusterRuntime((3.0, 1.0, 7.0, 2.0), "jsq")
    js = jr.open_session()
    js.feed(jserve.WorkloadSource(jwl))
    js.advance(until=10.0)
    js.submit(jserve.TaskSubmit(t=10.5, work=2.0, packets=1.0))
    js.drain()
    assert json.dumps(m.summary()) == json.dumps(jr.metrics.summary())


def test_session_context_manager_and_auto_tids():
    rt = ClusterRuntime((1.0, 1.0), "jsq")
    with rt.open_session() as s:
        a = s.submit({"t": 0.0, "work": 1.0})
        b = s.submit(TaskSubmit(t=0.5, work=1.0))
        c = s.submit(Task(tid=7, t_arrive=1.0, work=1.0, packets=1.0), 1.0)
        d = s.submit({"t": 1.5, "work": 1.0})
        s.drain()
    assert s.closed
    assert [x.tid for x in (a, b, c)] == [0, 1, 7]
    assert d.tid == 8, "counter jumps past explicitly-named tids"
    assert rt.metrics.completed == 4


def test_live_tids_never_collide_with_streaming_source():
    wl = make_workload("poisson", horizon=30.0, seed=5, rate=2.0)
    rt = ClusterRuntime((2.0, 1.0), "jsq")
    with rt.open_session() as s:
        s.feed(WorkloadSource(wl))
        s.advance(until=3.0)
        live = [s.submit({"t": 4.0 + i, "work": 1.0}) for i in range(3)]
        m = s.drain()
    assert m.completed == wl.m + 3
    assert all(t.tid >= wl.m for t in live)


def test_submit_guards():
    rt = ClusterRuntime((1.0,), "jsq")
    rt.submit(Task(tid=0, t_arrive=0.0, work=1.0, packets=1.0), 0.0)
    rt.advance(until=0.5)
    with pytest.raises(ValueError):  # tid already known to this runtime
        rt.submit(Task(tid=0, t_arrive=0.6, work=1.0, packets=1.0), 0.6)
    rt.advance(until=5.0)
    with pytest.raises(ValueError):  # the clock never goes backwards
        rt.submit(Task(tid=1, t_arrive=1.0, work=1.0, packets=1.0), 1.0)


def test_advance_event_budget_and_strict():
    wl = make_workload("poisson", horizon=15.0, seed=2, rate=3.0)
    rt = ClusterRuntime(POWERS, "jsq")
    rt.schedule_workload(wl)
    assert rt.advance(max_events=3) == 3
    assert rt.advance(max_events=10**9) > 0  # runs dry within budget
    assert rt.metrics.completed == wl.m
    rt2 = ClusterRuntime(POWERS, "jsq")
    rt2.schedule_workload(wl)
    with pytest.raises(RuntimeError, match="budget"):
        rt2.advance(max_events=3, strict=True)


def test_run_is_session_composition():
    """The monolithic run() is exactly feed + drain on a twin runtime."""
    wl = make_workload("bursty", horizon=40.0, seed=3, rate_lo=0.5,
                       rate_hi=8.0, work_mean=4.0)
    ref = ClusterRuntime(POWERS, "psts", trigger_period=1.0, seed=1,
                         policy_kwargs={"floor": 0.05})
    ref.run(wl)
    twin = ClusterRuntime(POWERS, "psts", trigger_period=1.0, seed=1,
                          policy_kwargs={"floor": 0.05})
    with twin.open_session() as s:
        s.feed(WorkloadSource(wl))
        s.drain()
    _assert_identical(ref, twin)


# ---------------------------------------------------------------------------
# streaming == offline replay under churn, and == the JAX package's stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 19, 101, 555])
def test_streaming_matches_offline_under_churn(seed):
    trace, failures, joins, resizes = _churn_inputs(PORT, seed)
    off = _offline(PORT, trace, failures, joins, resizes)
    svc = _online(PORT, trace, failures, joins, resizes)
    _assert_identical(off, svc.rt)
    assert svc.log.counts["complete"] == trace.m
    jsvc = _online(REF, *_churn_inputs(REF, seed))
    _assert_equals_reference(svc, jsvc)


@pytest.mark.parametrize("seed", [7, 101])
@pytest.mark.parametrize("step", [0.3, 1.7])
def test_fixed_step_pacing_matches_offline(seed, step):
    trace, failures, joins, resizes = _churn_inputs(PORT, seed)
    off = _offline(PORT, trace, failures, joins, resizes)
    svc = _online(PORT, trace, failures, joins, resizes, step=step)
    _assert_identical(off, svc.rt)
    jsvc = _online(REF, *_churn_inputs(REF, seed), step=step)
    _assert_equals_reference(svc, jsvc)


@settings(**STREAM_PROFILE)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_streaming_matches_offline_property(seed):
    trace, failures, joins, resizes = _churn_inputs(PORT, seed)
    off = _offline(PORT, trace, failures, joins, resizes)
    svc = _online(PORT, trace, failures, joins, resizes)
    _assert_identical(off, svc.rt)
    _assert_equals_reference(svc, _online(REF, *_churn_inputs(REF, seed)))


def test_bounded_microsteps_compose(seed=19):
    """However the advance() calls are sliced, the composed run is the
    same run."""
    results = []
    for pkg in (PORT, REF):
        trace, failures, joins, resizes = _churn_inputs(pkg, seed)
        off = _offline(pkg, trace, failures, joins, resizes)
        svc = pkg[2].SchedulerService(_psts(pkg))
        svc.rt.schedule_faults(failures=failures, joins=joins,
                               resizes=resizes)
        svc.attach(pkg[2].WorkloadSource(trace))
        while svc.session.pending_sources or svc.rt.pending_work():
            svc.advance(until=svc.now + 0.9, max_events=5)
        svc.drain()
        _assert_identical(off, svc.rt)
        results.append(svc)
    _assert_equals_reference(*results)


# ---------------------------------------------------------------------------
# the online lab backend: byte-identical RunResult
# ---------------------------------------------------------------------------

def _churn_scenario(pkg=lab) -> lab.Scenario:
    return pkg.Scenario(
        cluster=pkg.ClusterSpec(n_nodes=6, power_seed=3, bandwidth=128.0),
        workload=pkg.WorkloadSpec(process="bursty", horizon=40.0,
                                  work_mean=4.0,
                                  params={"rate_lo": 0.5, "rate_hi": 8.0}),
        policy=pkg.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.05}),
        faults=pkg.FaultSpec(failures=((10.0, 1),), joins=((22.0, 1),),
                             resizes=((15.0, 2, 0.5),)),
        seed=11)


def _assert_result_equals(got, want) -> None:
    """Two RunResults equal as JSON, byte for byte."""
    assert json.dumps(got.to_dict(), sort_keys=True) == \
        json.dumps(want.to_dict(), sort_keys=True)


def test_online_backend_matches_events():
    sc = _churn_scenario()
    e = lab.run(sc, backend="events")
    o = lab.run(sc, backend="online")
    assert o.backend == "online"
    assert o.backend_options["model"] == "incremental-service"
    assert o.backend_options["pacing"] == "arrivals"
    assert o.backend_options["micro_steps"] > 0
    assert json.dumps(o.metrics) == json.dumps(e.metrics)
    assert o.extras.get("work_census") == e.extras.get("work_census")
    d = o.backend_options["decisions"]
    assert d["complete"] == o["completed"]
    assert d["trigger"] == o["trigger_evals"]
    _assert_result_equals(o, jlab.run(_churn_scenario(jlab),
                                      backend="online"))


def test_online_backend_fixed_step_and_option_validation():
    sc = _churn_scenario()
    e = lab.run(sc, backend="events")
    o = lab.run(sc, backend="online", step=0.5)
    assert json.dumps(o.metrics) == json.dumps(e.metrics)
    assert o.backend_options["pacing"] == 0.5
    _assert_result_equals(o, jlab.run(_churn_scenario(jlab),
                                      backend="online", step=0.5))
    with pytest.raises(ValueError, match="step"):
        lab.run(sc, backend="online", step=0.0)
    with pytest.raises(TypeError, match="step only"):
        lab.run(sc, backend="online", nonsense=1)
    # the host service takes no device, as the reference's takes none
    with pytest.raises(TypeError, match="step only"):
        lab.run(sc, backend="online", device="cpu")


def _dag_scenario(pkg=lab):
    return pkg.Scenario(
        cluster=pkg.ClusterSpec(powers=(2.0, 1.0, 3.0), bandwidth=64.0),
        workload=pkg.WorkloadSpec(process="poisson", horizon=25.0,
                                  work_mean=3.0, params={"rate": 2.0},
                                  dag={"kind": "random", "p": 0.3}),
        policy=pkg.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.05}),
        seed=5)


def test_online_backend_dag_workload():
    sc = _dag_scenario()
    e = lab.run(sc, backend="events")
    o = lab.run(sc, backend="online")
    assert json.dumps(o.metrics) == json.dumps(e.metrics)
    assert o["cp_lower_bound"] > 0
    assert o.extras.get("work_census") == e.extras.get("work_census")
    _assert_result_equals(o, jlab.run(_dag_scenario(jlab), backend="online"))


def _replay_scenario(pkg):
    """trace-replay-16: the bundled excerpt, whole, with its constraints,
    requeue evictions and machine events, on a 16-node 4-class cluster."""
    return pkg.Scenario(
        name="trace/psts/aware",
        cluster=pkg.ClusterSpec(
            powers=(1.0,) * 4 + (1.25,) * 4 + (1.75,) * 4 + (2.0,) * 4,
            attrs={"machine_class": (0.0,) * 4 + (1.0,) * 4 + (2.0,) * 4
                   + (3.0,) * 4},
            bandwidth=256.0),
        workload=pkg.WorkloadSpec(
            trace=pkg.TraceRef(
                path=str(EXCERPT), format="google",
                params={"constraints_path": str(
                    DATA / "google_excerpt_10k_constraints.csv.gz"),
                    "eviction_mode": "requeue"},
                machine_events=str(
                    DATA / "google_excerpt_10k_machine_events.csv.gz")),
            horizon=None),
        policy=pkg.PolicySpec("psts", trigger_period=2.0,
                              params={"floor": 0.05},
                              constraint_mode="aware"))


@pytest.mark.filterwarnings("ignore:google trace")
def test_online_backend_replays_the_excerpt_as_events_do():
    sc = _replay_scenario(lab)
    e = lab.run(sc, backend="events")
    o = lab.run(sc, backend="online")
    assert json.dumps(o.metrics) == json.dumps(e.metrics)
    assert json.dumps(o.extras, sort_keys=True) == \
        json.dumps(e.extras, sort_keys=True)
    for k in ("evictions", "failures", "joins", "resizes"):
        assert o[k] > 0, k
    assert o["completed"] == o["arrived"] == 10_000
    d = o.backend_options["decisions"]
    assert d["complete"] == o["completed"] and d["evict"] > 0
    _assert_result_equals(o, jlab.run(_replay_scenario(jlab),
                                      backend="online"))


def test_online_backend_registered_lazily():
    b = lab.get_backend("online")
    assert b.name == "online" and "online" in lab.BACKENDS
    member = lab.Scenario(cluster=lab.ClusterSpec(n_nodes=2))
    fed = lab.Federation(members=(member, member),
                         topology=lab.TopologySpec(kind="isolated"))
    assert b.eligible(fed) is not None
    jmember = jlab.Scenario(cluster=jlab.ClusterSpec(n_nodes=2))
    jfed = jlab.Federation(members=(jmember, jmember),
                           topology=jlab.TopologySpec(kind="isolated"))
    assert b.eligible(fed) == jlab.get_backend("online").eligible(jfed)


# ---------------------------------------------------------------------------
# the decision stream
# ---------------------------------------------------------------------------

def test_decision_stream_is_ordered_and_counted():
    trace, failures, joins, resizes = _churn_inputs(PORT, 7)
    svc = _online(PORT, trace, failures, joins, resizes)
    log = svc.log
    assert len(log) == sum(log.counts.values()) > 0
    assert [d.seq for d in log] == list(range(len(log)))
    ts = [d.t for d in log]
    assert ts == sorted(ts), "decisions emit in event order"
    m = svc.metrics
    assert log.counts["complete"] == m.completed
    assert log.counts["trigger"] == m.trigger_evals
    fired = sum(1 for d in log if d.kind == "trigger" and d.info["fired"])
    assert fired == m.trigger_fires
    assert log.counts["evict"] <= m.evictions
    assert log.counts["place"] >= m.completed


def test_requeue_eviction_emits_evict_decision():
    services = []
    for pkg in (PORT, REF):
        svc = pkg[2].SchedulerService(pkg[0]((1.0,), "jsq"))
        svc.submit({"t": 0.0, "work": 10.0}, evictions=(2.0,))
        m = svc.drain()
        assert m.completed == 1 and m.evictions == 1
        assert svc.log.counts["evict"] == 1
        [d] = [d for d in svc.log if d.kind == "evict"]
        assert d.t == 2.0 and d.info["running"] is True and d.node == 0
        services.append(svc)
    _assert_equals_reference(*services)


def test_decision_to_dict_round_trips_as_json():
    p = Decision(0, 1.5, "place", tid=3, node=2)
    g = Decision(1, 2.0, "migrate", tid=3, src=2, dst=0)
    t = Decision(2, 3.0, "trigger", info={"fired": True})
    assert p.to_dict() == {"seq": 0, "t": 1.5, "kind": "place",
                           "tid": 3, "node": 2}
    assert g.to_dict() == {"seq": 1, "t": 2.0, "kind": "migrate",
                           "tid": 3, "src": 2, "dst": 0}
    d = json.loads(json.dumps(t.to_dict()))
    assert d["kind"] == "trigger" and d["fired"] is True
    assert "tid" not in d and "node" not in d
    for ours in (p, g, t):
        theirs = jserve.Decision(ours.seq, ours.t, ours.kind, tid=ours.tid,
                                 node=ours.node, src=ours.src, dst=ours.dst,
                                 info=dict(ours.info))
        assert json.dumps(ours.to_dict()) == json.dumps(theirs.to_dict())


def test_decision_log_streaming_and_drain():
    got = []
    log = DecisionLog(keep=False, on_decision=got.append)
    wl = make_workload("poisson", horizon=10.0, seed=4, rate=2.0)
    rt = ClusterRuntime((2.0, 1.0), "jsq")
    svc = SchedulerService(rt, log=log)
    svc.attach(WorkloadSource(wl))
    svc.drain()
    assert len(log) == 0, "keep=False retains nothing"
    assert len(got) == sum(log.counts.values()) > 0
    rt2 = ClusterRuntime((2.0, 1.0), "jsq")
    svc2 = SchedulerService(rt2)
    svc2.attach(WorkloadSource(wl))
    svc2.drain()
    popped = svc2.log.drain()
    assert len(popped) == len(got) and len(svc2.log.decisions) == 0
    assert _stream(popped) == _stream(got)


def test_advance_returns_only_new_decisions():
    wl = make_workload("poisson", horizon=20.0, seed=1, rate=2.0)
    svc = SchedulerService(ClusterRuntime((2.0, 1.0), "jsq"))
    svc.attach(WorkloadSource(wl))
    first = svc.advance(until=10.0)
    second = svc.advance(until=1e9)
    assert first and second
    assert {d.seq for d in first}.isdisjoint({d.seq for d in second})
    assert len(first) + len(second) == len(svc.log.decisions)


# ---------------------------------------------------------------------------
# task sources
# ---------------------------------------------------------------------------

def test_tasksubmit_from_dict_and_to_task():
    d = {"t_arrive": 2.0, "work": 3.0, "packets": 2, "parents": [1, 2],
         "evictions": [5.0], "user": "alice"}
    ts = TaskSubmit.from_dict(d)
    assert ts.t == 2.0 and ts.parents == (1, 2) and ts.evictions == (5.0,)
    assert ts.info == {"user": "alice"}, "unknown keys ride along as info"
    jts = jserve.TaskSubmit.from_dict(d)
    assert (ts.t, ts.work, ts.packets, ts.parents, ts.evictions, ts.info) \
        == (jts.t, jts.work, jts.packets, jts.parents, jts.evictions,
            jts.info)
    task = ts.to_task(9)
    assert task.tid == 9 and task.t_arrive == 2.0 and task.parents == (1, 2)
    con = TaskSubmit(t=0.0, work=1.0, feasible=[0, 2])
    with pytest.raises(ValueError, match="capacity"):
        con.to_task(0)
    mask = con.to_task(0, capacity=4).feasible
    assert mask.dtype == np.bool_ and list(mask) == [True, False, True,
                                                     False]
    np.testing.assert_array_equal(
        mask, jserve.TaskSubmit(t=0.0, work=1.0, feasible=[0, 2]).to_task(
            0, capacity=4).feasible)


def test_iterable_source_pull_boundary():
    src = IterableSource([TaskSubmit(t=1.0, work=1.0),
                          {"t": 2.0, "work": 1.0},
                          TaskSubmit(t=3.0, work=1.0)])
    assert [ts.t for ts in src.pull(1.5)] == [1.0]
    assert not src.exhausted, "lookahead buffers the t=2 item"
    assert [ts.t for ts in src.pull(3.0)] == [2.0, 3.0]
    assert src.pull(99.0) == []
    assert src.exhausted


def test_jsonl_source_from_file_like_and_path(tmp_path):
    text = ('{"t": 0.5, "work": 2.0}\n'
            '\n'
            '{"t": 1.0, "work": 1.0, "packets": 3}\n')
    src = JsonlSource(io.StringIO(text))
    got = src.pull(10.0)
    assert [ts.t for ts in got] == [0.5, 1.0] and got[1].packets == 3
    assert src.exhausted
    path = tmp_path / "feed.jsonl"
    path.write_text(text)
    rt = ClusterRuntime((1.0, 1.0), "jsq")
    with rt.open_session() as s:
        s.feed(JsonlSource(str(path)))
        m = s.drain()
    assert m.completed == 2
    jr = jrt.ClusterRuntime((1.0, 1.0), "jsq")
    with jr.open_session() as js:
        js.feed(jserve.JsonlSource(str(path)))
        js.drain()
    assert json.dumps(m.summary()) == json.dumps(jr.metrics.summary())


def test_workload_source_streams_in_admission_order():
    trace = ptraces.TraceSchema(
        t_arrive=np.array([0.5, 1.0, 1.0]), works=np.ones(3),
        packets=np.ones(3), priority=np.array([1, 2, 0], dtype=np.int32))
    src = WorkloadSource(trace)
    got = src.pull(5.0)
    assert [ts.tid for ts in got] == [0, 2, 1]
    assert src.next_time is None and src.exhausted


def test_workload_source_guards_unprepared_state():
    trace, *_ = _churn_inputs(PORT, 0)  # carries evictions
    src = WorkloadSource(trace)
    with pytest.raises(RuntimeError, match="prepare"):
        src.pull(1e9)


# ---------------------------------------------------------------------------
# unified verbs across layers + deprecation shims
# ---------------------------------------------------------------------------

def test_service_operator_verbs_fail_join_resize():
    services = []
    for pkg in (PORT, REF):
        svc = pkg[2].SchedulerService(pkg[0]((1.0, 1.0), "jsq"))
        for _ in range(4):
            svc.submit({"t": 0.0, "work": 4.0})
        svc.advance(until=0.5)
        svc.fail(1)               # t defaults to now
        svc.join(1, 6.0)
        svc.resize(0, 2.0, 8.0)
        m = svc.drain()
        svc.close()
        assert m.completed == 4
        assert m.failures == 1 and m.joins == 1
        services.append(svc)
    _assert_equals_reference(*services)


def _fed(pkg):
    return pkg.Federation(
        members=tuple(
            pkg.Scenario(
                name=f"dc{i}",
                cluster=pkg.ClusterSpec(n_nodes=3, power_seed=i,
                                        bandwidth=128.0),
                workload=pkg.WorkloadSpec(process="poisson", horizon=30.0,
                                          work_mean=5.0,
                                          params={"rate": r}),
                policy=pkg.PolicySpec("psts", trigger_period=1.0,
                                      params={"floor": 0.05}),
                seed=i)
            for i, r in enumerate((6.0, 2.0))),
        topology=pkg.TopologySpec(kind="full", bandwidth=8.0, latency=2.0),
        exchange_period=4.0)


def test_federated_runtime_shares_the_session_verbs():
    from repro.federation import FederatedRuntime as JFederatedRuntime
    from repro_torch.federation import FederatedRuntime
    fed = _fed(lab)
    ref = FederatedRuntime(fed).run()
    fr = FederatedRuntime(fed)
    n = fr.advance(until=12.0)          # partial: whole epochs only
    assert 0 < n <= 3
    report = fr.drain()
    assert report.aggregate.summary() == ref.aggregate.summary()
    assert report.epochs == ref.epochs
    fr2 = FederatedRuntime(fed)
    fr2.advance(until=8.0)
    fr2.submit(Task(tid=90_000, t_arrive=8.0, work=3.0, packets=1.0),
               member=1)
    r2 = fr2.drain()
    assert r2.aggregate.completed == ref.aggregate.completed + 1
    jr2 = JFederatedRuntime(_fed(jlab))
    jr2.advance(until=8.0)
    jr2.submit(jrt.runtime.Task(tid=90_000, t_arrive=8.0, work=3.0,
                                packets=1.0), member=1)
    assert json.dumps(r2.aggregate.summary()) == \
        json.dumps(jr2.drain().aggregate.summary())


def test_deprecated_inject_and_step_until_still_work():
    rt = ClusterRuntime((2.0, 2.0), "jsq")
    with pytest.warns(DeprecationWarning, match="inject"):
        rt.inject(Task(tid=0, t_arrive=1.0, work=2.0, packets=1.0), 1.0)
    with pytest.warns(DeprecationWarning, match="step_until"):
        rt.step_until(1e9)
    assert rt.metrics.completed == 1


def test_run_policy_shim_warns_and_matches_session_api():
    wl = make_workload("poisson", horizon=15.0, seed=6, rate=2.0)
    with pytest.warns(DeprecationWarning, match="open_session"):
        m = run_policy("psts", wl, POWERS, trigger_period=1.0, seed=0,
                       policy_kwargs={"floor": 0.05})
    rt = _psts()
    with rt.open_session() as s:
        s.feed(WorkloadSource(wl))
        s.drain()
    assert m.summary() == rt.metrics.summary()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jm = jrt.run_policy("psts", jrt.make_workload(
            "poisson", horizon=15.0, seed=6, rate=2.0), POWERS,
            trigger_period=1.0, seed=0, policy_kwargs={"floor": 0.05})
    assert json.dumps(m.summary()) == json.dumps(jm.summary())


def test_stable_public_api_surface():
    assert repro_torch.Scenario is lab.Scenario
    assert repro_torch.run is lab.run
    assert repro_torch.sweep is lab.sweep
    assert repro_torch.RunResult is lab.RunResult
    assert repro_torch.SchedulerService is SchedulerService
    assert set(repro_torch.__all__) >= {"Scenario", "run", "sweep",
                                        "RunResult", "SchedulerService",
                                        "__version__"}
    assert set(serve.__all__) == set(jserve.__all__)
    assert {"Scenario", "run", "sweep", "RunResult"} <= set(lab.__all__)
    with pytest.raises(AttributeError):
        repro_torch.nonsense
    # the serving engine still loads from the package, lazily
    from repro_torch.serve import Engine, GenRequest
    assert Engine.__module__ == GenRequest.__module__ == \
        "repro_torch.serve.engine"


# ---------------------------------------------------------------------------
# the ops plane over a live service (tests/test_ops.py's serve cases)
# ---------------------------------------------------------------------------

def _ops_scenario(pkg, obs=None, *, rate=3.0, horizon=30.0, n=8,
                  period=1.0):
    return pkg.Scenario(
        name="ops-test",
        cluster=pkg.ClusterSpec(n_nodes=n, power_seed=3),
        workload=pkg.WorkloadSpec(process="poisson", horizon=horizon,
                                  work_mean=5.0, params={"rate": rate}),
        policy=pkg.PolicySpec("psts", trigger_period=period,
                              params={"floor": 0.05}),
        obs=obs)


def _steady(text: str) -> list[str]:
    """An exposition's lines but the wall-clock decision latencies (the
    only values that cannot equal the JAX package's)."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("sched_decision_latency_us{")]


def test_online_service_scrape_matches_summary():
    scrapes = []
    for pkg in (lab, jlab):
        svc_mod = serve if pkg is lab else jserve
        sc = _ops_scenario(pkg, pkg.ObsSpec(probe_every=1.0, metrics=True))
        svc = svc_mod.SchedulerService.from_scenario(sc)
        svc.advance(until=10.0)
        mid = svc.scrape()
        assert parse_openmetrics(mid)["sched_queued_tasks"]["type"] == \
            "gauge"
        svc.drain()
        text = svc.scrape()
        fams = parse_openmetrics(text)
        summary = svc.summary()
        for key in ("completed", "makespan", "migrations"):
            sample = fams["sched_" + key]["samples"][0]
            assert sample[2] == pytest.approx(float(summary[key])), key
        snap = svc.instruments.registry.snapshot()
        assert snap["sched_tasks_completed_total"]["samples"][""] == \
            summary["completed"]
        assert svc.instruments.registry.value(
            "sched_decisions_total", kind="place") == svc.log.counts["place"]
        scrapes.append((_steady(mid), _steady(text), json.dumps(summary)))
    assert scrapes[0] == scrapes[1]


def test_session_scrape_on_uninstrumented_runtime():
    rt = ClusterRuntime((2.0, 1.0, 1.0, 0.5), "jsq")
    s = rt.open_session()
    wl = make_workload("poisson", horizon=10.0, seed=1, rate=2.0)
    s.feed(WorkloadSource(wl))
    s.advance(until=5.0)
    first = attach_collector(rt)
    fams = parse_openmetrics(s.scrape())
    assert "sched_queued_tasks" in fams
    s.drain()
    assert attach_collector(rt) is first  # get-or-create, not re-install
    fams = parse_openmetrics(s.scrape())
    assert fams["sched_completed"]["samples"][0][2] == s.metrics.completed


def test_alerts_stream_through_decision_log():
    services = []
    for pkg, svc_mod in ((lab, serve), (jlab, jserve)):
        sc = _ops_scenario(pkg, pkg.ObsSpec(probe_every=0.5, anomaly=True),
                           rate=40.0, horizon=15.0, period=100.0)
        svc = svc_mod.SchedulerService.from_scenario(sc)
        svc.drain()
        alerts = [d for d in svc.log if d.kind == "alert"]
        assert alerts and alerts[0].info["kind"] == "queue_growth"
        assert svc.log.counts["alert"] == len(alerts)
        services.append(svc)
    _assert_equals_reference(*services)
