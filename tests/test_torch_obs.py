"""The port's telemetry subsystem (``repro_torch.obs``) held against the JAX
package's ``repro.obs`` on the CPU.

The same events run gives the same ``export_obs`` payload and the same
OpenMetrics exposition in both packages, except for the wall-clock
decision latencies: the tracer's ``decision_stats`` ``mean_us``,
``p99_us``, ``p999_us`` and ``max_us`` (also under the Chrome trace's
``otherData``) and the ``sched_decision_latency_us`` gauge that mirrors
them (``WALL_CLOCK`` and ``LATENCY_GAUGE`` below). The tracer, ring, probe,
monitor, registry, exposition and anomaly cases of ``tests/test_obs.py``
and ``tests/test_ops.py`` that need neither federation, the scheduler
service nor the lab CLI run on the port as well; those that need the
service or the CLI are in ``tests/test_torch_online.py`` and
``tests/test_torch_cli.py``.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro import lab as jlab
from repro import obs as jobs
from repro.lab import backends as jbackends
from repro_torch import lab
from repro_torch import obs as pobs
from repro_torch.core.hypergrid import HyperGrid, factorize
from repro_torch.lab import backends
from repro_torch.obs import (
    PID_SCHED,
    AnomalyMonitor,
    Counter,
    CriticalPointMonitor,
    EwmaMad,
    FanoutSink,
    Histogram,
    MetricsHTTPServer,
    MetricsRegistry,
    NullTracer,
    ProbeSeries,
    RegistryCollector,
    Tracer,
    attach_collector,
    export_obs,
    log_buckets,
    merge_chrome_traces,
    merge_registries,
    parse_openmetrics,
    to_openmetrics,
)
from repro_torch.obs.export import main as lint_cli
from repro_torch.obs.probe import _imbalance_by_level_batch, imbalance_by_level
from repro_torch.runtime import ClusterRuntime, make_workload

WALL_CLOCK = ("mean_us", "p99_us", "p999_us", "max_us")
LATENCY_GAUGE = "sched_decision_latency_us"


def _scenario(pkg, obs=None, *, horizon=80.0, faults=True, rate=3.0,
              period=1.0, seed=0):
    return pkg.Scenario(
        name="obs-test",
        cluster=pkg.ClusterSpec(n_nodes=8, power_seed=3, bandwidth=64.0),
        workload=pkg.WorkloadSpec(process="poisson", horizon=horizon,
                                  work_mean=5.0, params={"rate": rate}),
        policy=pkg.PolicySpec("psts", trigger_period=period,
                              params={"floor": 0.05}),
        faults=pkg.FaultSpec(failures=((20.0, 1), (21.0, 2)),
                             joins=((45.0, 1), (46.0, 2)))
        if faults else pkg.FaultSpec(),
        obs=obs, seed=seed)


def _run_obs(**obs_kwargs):
    r = lab.run(_scenario(lab, lab.ObsSpec(**obs_kwargs)))
    return r, r.extras["obs"]


def _scrub(payload):
    """``export_obs`` output with the wall-clock latencies set to None."""
    payload = json.loads(json.dumps(payload))
    for stats in (payload.get("decision_stats"),
                  payload.get("chrome_trace", {}).get("otherData", {})
                  .get("decision_stats")):
        for s in (stats or {}).values():
            for k in WALL_CLOCK:
                s[k] = None
    gauge = payload.get("metrics", {}).get(LATENCY_GAUGE)
    if gauge is not None:
        gauge["samples"] = {k: None for k in gauge["samples"]}
    return payload


def _run_both(obs_kwargs, **scenario_kwargs):
    """One scenario through each package's events lowering; returns the
    (reference, port) runtimes and instruments after the run."""
    out = []
    for pkg, be in ((jlab, jbackends), (lab, backends)):
        sc = _scenario(pkg, pkg.ObsSpec(**obs_kwargs), **scenario_kwargs)
        rt, wl, ins, (failures, joins, resizes) = \
            be.build_events_runtime(sc)
        rt.run(wl, failures=failures, joins=joins, resizes=resizes)
        out.append((rt, ins))
    return out


# ---------------------------------------------------------------------------
# export_obs and the OpenMetrics exposition equal the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("obs_kwargs", [
    dict(trace=True),
    dict(trace=True, ring=64, latency_sample=1),
    dict(probe_every=2.5),
    dict(trace=True, probe_every=1.0, metrics=True),
    dict(probe_every=0.5, metrics=True, anomaly=True),
], ids=["trace", "ring-census", "probe", "trace-probe-metrics", "anomaly"])
def test_export_obs_matches_reference(obs_kwargs):
    (jrt, jins), (rt, ins) = _run_both(obs_kwargs)
    assert rt.metrics.summary() == jrt.metrics.summary()
    for full in (True, False):
        got = export_obs(ins, include_trace=full)
        want = jobs.export_obs(jins, include_trace=full)
        assert got.keys() == want.keys()
        assert _scrub(got) == _scrub(want)
    if "decision_stats" in got:
        for kind, s in got["decision_stats"].items():
            assert s["n"] == want["decision_stats"][kind]["n"] > 0
            assert s["mean_us"] > 0.0  # a wall-clock reading was taken


@pytest.mark.parametrize("trace", [False, True])
def test_openmetrics_scrape_matches_reference(trace):
    obs_kwargs = dict(trace=trace, probe_every=0.5, metrics=True,
                      anomaly=True)
    (_, jins), (_, ins) = _run_both(obs_kwargs, rate=40.0, horizon=20.0,
                                    period=100.0, faults=False)
    got = ins.collector.scrape()
    want = jins.collector.scrape()

    def lines(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith(LATENCY_GAUGE + "{")]
    assert lines(got) == lines(want)
    assert (LATENCY_GAUGE + "{" in got) == trace
    fams = parse_openmetrics(got)
    assert fams["sched_completed"]["samples"][0][2] == \
        ins.collector._rt.metrics.completed
    # the registry snapshot (scrape-time state) agrees as a whole
    assert (_scrub({"metrics": ins.registry.snapshot()})
            == _scrub({"metrics": jins.registry.snapshot()}))


def test_openmetrics_of_sample_registry_matches_reference():
    texts = []
    for pkg in (jobs, pobs):
        reg = pkg.MetricsRegistry()
        reg.counter("jobs_total", "jobs", labels=("kind",)).inc(3, kind="a")
        reg.gauge("load", "cluster load").set(1.5)
        h = reg.histogram("resp", "response", labels=("tier",),
                          buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 5.0, 50.0):
            h.observe(v, tier="0")
        texts.append(pkg.to_openmetrics(reg))
    assert texts[1] == texts[0]
    fams = parse_openmetrics(texts[1])
    assert fams == jobs.parse_openmetrics(texts[0])
    assert fams["jobs"]["samples"] == [("jobs_total", {"kind": "a"}, 3.0)]
    buckets = [v for name, _, v in fams["resp"]["samples"]
               if name == "resp_bucket"]
    assert buckets == [1.0, 2.0, 3.0, 4.0]


# ---------------------------------------------------------------------------
# tracer: chrome-trace schema, ring, decision stats
# ---------------------------------------------------------------------------

def test_chrome_trace_schema_is_valid_and_strict_json():
    tr = Tracer()
    tr.span("work", 1.0, 3.5, tid=7, args={"w": 2.0})
    tr.instant("mark", 2.0, pid=PID_SCHED, cat="sched")
    tr.counter("queued", 2.5, {"a": 1, "b": 2})
    doc = json.loads(json.dumps(tr.to_chrome_trace(), allow_nan=False))
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    assert {e["args"]["name"] for e in meta} == {"nodes", "tasks",
                                                "scheduler"}
    for e in events:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] != "M":
            assert isinstance(e["ts"], float) and {"cat", "args"} <= set(e)
    x = next(e for e in events if e["ph"] == "X")
    assert x["ts"] == pytest.approx(1.0e6)
    assert x["dur"] == pytest.approx(2.5e6)
    assert x["args"] == {"w": 2.0}
    i = next(e for e in events if e["ph"] == "i")
    assert i["s"] == "t" and i["pid"] == PID_SCHED
    c = next(e for e in events if e["ph"] == "C")
    assert c["args"] == {"a": 1, "b": 2}
    assert doc["otherData"]["n_events"] == 3
    ref = jobs.Tracer()
    ref.span("work", 1.0, 3.5, tid=7, args={"w": 2.0})
    ref.instant("mark", 2.0, pid=PID_SCHED, cat="sched")
    ref.counter("queued", 2.5, {"a": 1, "b": 2})
    assert tr.to_chrome_trace() == ref.to_chrome_trace()


def test_tracer_negative_duration_clamps_to_zero():
    tr = Tracer()
    tr.span("backwards", 2.0, 1.0)
    x = next(e for e in tr.to_chrome_trace()["traceEvents"]
             if e["ph"] == "X")
    assert x["dur"] == 0.0


def test_begin_end_merges_args_and_reports_unmatched():
    tr = Tracer()
    tr.begin(("migrate", 4), 1.0, args={"src": 0})
    assert tr.end(("migrate", 4), "migrate", 2.0, tid=4, args={"dst": 3})
    assert not tr.end(("migrate", 99), "migrate", 2.0)  # no begin
    x = next(e for e in tr.to_chrome_trace()["traceEvents"]
             if e["ph"] == "X")
    assert x["args"] == {"src": 0, "dst": 3}
    assert x["ts"] == pytest.approx(1.0e6)


def test_ring_keeps_newest_events_and_counts_drops():
    tr = Tracer(ring=4)
    for i in range(10):
        tr.instant(f"e{i}", float(i))
    assert tr.n_events == 4
    assert tr.n_dropped == 6
    names = [e["name"] for e in tr.to_chrome_trace()["traceEvents"]
             if e["ph"] == "i"]
    assert names == ["e6", "e7", "e8", "e9"]
    tr2 = Tracer(ring=2)
    tr2.begin(("k",), 0.0)
    for i in range(5):
        tr2.instant(f"x{i}", float(i))
    assert tr2.end(("k",), "long", 9.0)
    assert tr2.n_events == 2
    with pytest.raises(ValueError):
        Tracer(ring=0)


def test_decision_stats_weighted_and_in_microseconds():
    tr = Tracer()
    for lat in (1e-6, 2e-6, 3e-6):
        tr.decision("place", lat)
    s = tr.decision_stats()["place"]
    assert s["n"] == 3
    assert s["mean_us"] == pytest.approx(2.0)
    assert s["max_us"] == pytest.approx(3.0)
    assert tr.n_events == 0
    tr = Tracer(latency_sample=4)
    for lat in (1e-6, 2e-6, 3e-6, 4e-6):
        tr.decision("place", lat, weight=4)
    s = tr.decision_stats()["place"]
    assert s["n"] == 16 and s["sampled"] == 4
    assert s["p99_us"] == pytest.approx(4.0)
    with pytest.raises(ValueError):
        Tracer(latency_sample=0)


def test_null_tracer_swallows_everything():
    nt = NullTracer()
    nt.span("a", 0.0, 1.0)
    nt.instant("b", 0.0)
    nt.counter("c", 0.0, {})
    nt.decision("d", 1e-6)
    assert nt.end(("k",), "a", 1.0) is False
    assert nt.n_events == 0 and not nt.enabled
    assert nt.to_chrome_trace()["traceEvents"] == []
    assert nt.decision_stats() == {}


def test_task_span_contains_service_and_migrate_spans():
    r, obs = _run_obs(trace=True)
    events = obs["chrome_trace"]["traceEvents"]
    tasks = {e["tid"]: e for e in events if e["name"] == "task"}
    assert len(tasks) == r.metrics["completed"]
    for e in events:
        if e["ph"] != "X" or e["name"] == "task":
            continue
        parent = tasks[e["tid"]]
        assert parent["ts"] <= e["ts"] + 1e-3
        assert (e["ts"] + e["dur"]
                <= parent["ts"] + parent["dur"] + 1e-3), e
        if e["name"] == "migrate":
            assert e["args"]["src"] != e["args"]["dst"]
            assert e["dur"] > 0
    services = [e for e in events if e["name"] == "service"]
    assert len([e for e in services if not e["args"]]) \
        == r.metrics["completed"]
    assert all(e["args"]["interrupted"] for e in services if e["args"])
    assert sum(e["name"] == "fail" for e in events) == r.metrics["failures"]
    assert sum(e["name"] == "join" for e in events) == r.metrics["joins"]
    for e in events:  # no WAN hand-off, no causal ids
        assert "trace_id" not in (e.get("args") or {})


def test_engine_decision_latency_sampled_but_counted_in_full():
    _, obs = _run_obs(trace=True)
    stats = obs["decision_stats"]
    for kind in ("place", "trigger"):
        assert stats[kind]["n"] > 0
        assert stats[kind]["mean_us"] < 1000.0
    assert stats["place"]["n"] == stats["place"]["sampled"] * 8
    _, census = _run_obs(trace=True, latency_sample=1)
    s = census["decision_stats"]["place"]
    assert s["sampled"] == s["n"]


def test_ring_mode_through_the_lab():
    _, obs = _run_obs(trace=True, ring=32)
    assert obs["trace_events"] == 32
    assert obs["trace_dropped"] > 0
    assert len([e for e in obs["chrome_trace"]["traceEvents"]
                if e["ph"] != "M"]) == 32


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def test_probe_cadence_validation():
    for bad in (0.0, -1.0, math.nan, math.inf):
        with pytest.raises(ValueError):
            ProbeSeries(bad)
    with pytest.raises(ValueError):
        lab.ObsSpec(probe_every=0.0)


def test_probe_cadence_survives_fault_churn():
    _, obs = _run_obs(trace=False, probe_every=2.5)
    p = obs["probes"]
    t = p["t"]
    assert len(t) > 20
    assert np.allclose(np.diff(t), 2.5)
    assert t[-1] > 46.0
    n, width = len(t), len(p["node_load"][0])
    assert width == 8
    for key in ("node_load", "occupancy", "queue_depth"):
        assert len(p[key]) == n and all(len(row) == width for row in p[key])
    assert {len(row) for row in p["imbalance_by_level"]} == {3}
    for series in p["tier_work"].values():
        assert len(series) == n


def test_incremental_snapshot_matches_task_recount_under_churn():
    rng = np.random.default_rng(0)
    powers = rng.integers(1, 5, size=6).astype(float)
    rt = ClusterRuntime(powers, "psts", trigger_period=1.0,
                        bandwidth=32.0, probe=ProbeSeries(1.0))
    wl = make_workload("poisson", horizon=40.0, work_mean=4.0, seed=1,
                       rate=6.0)
    rt.schedule_workload(wl, failures=[(8.0, 0), (9.0, 3)],
                         joins=[(22.0, 0), (23.0, 3)])
    for t_cut in (5.0, 10.0, 20.0, 30.0, 200.0):
        rt.advance(until=t_cut)
        snap = rt.probe_snapshot(t_cut)
        assert np.allclose(snap["node_load"], rt.loads(t_cut), atol=1e-6)
        tiers = {}
        for q in rt._queues:
            for task in q:
                tiers[task.priority] = tiers.get(task.priority, 0.0) \
                    + task.work
        for tier, w in tiers.items():
            if w > 1e-9:
                assert snap["tier_work"].get(tier, 0.0) == pytest.approx(w)


def test_scalar_and_batched_imbalance_agree_with_stranded_inf():
    rng = np.random.default_rng(2)
    powers = rng.integers(1, 5, size=8).astype(float)
    powers[5] = 0.0
    grid = HyperGrid(factorize(8, 3), powers)
    loads = rng.uniform(0.0, 10.0, size=(12, 8))
    loads[::3, 5] = 0.0
    batch = _imbalance_by_level_batch(loads, grid)
    for i in range(loads.shape[0]):
        scalar = imbalance_by_level(loads[i], grid)
        for a, b in zip(batch[i], scalar):
            if math.isinf(b):
                assert math.isinf(a)
            else:
                assert a == pytest.approx(b)


def test_probe_to_dict_is_json_safe_with_stranded_work():
    grid = HyperGrid(factorize(4, 2), [2.0, 1.0, 0.0, 1.0])
    probe = ProbeSeries(1.0)
    probe.record(0.0, grid=grid, node_load=[1.0, 1.0, 0.5, 1.0],
                 queue_depth=[1, 1, 1, 1], tier_work={0: 3.5},
                 in_flight=0, queued_tasks=4)
    assert math.isinf(probe.imbalance[0][-1])
    d = probe.to_dict()
    json.dumps(d, allow_nan=False)
    assert any(None in row for row in d["imbalance_by_level"])


# ---------------------------------------------------------------------------
# critical-point monitor
# ---------------------------------------------------------------------------

def test_monitor_alignment_against_the_paper_bound():
    r, obs = _run_obs(trace=True, probe_every=5.0)
    trig = obs["trigger"]
    assert trig["summary"]["aligned"]
    assert trig["summary"]["n_evals"] == r.metrics["trigger_evals"]
    assert trig["summary"]["n_fires"] == r.metrics["trigger_fires"]
    for e in trig["events"]:
        if e["imbalance"] is None:
            assert e["fired"]
            continue
        assert e["fired"] == (e["imbalance"] > e["bound"])
        assert e["bound"] == pytest.approx(max(e["crossover"], e["floor"]))


def test_monitor_misaligned_event_detected():
    mon = CriticalPointMonitor()

    class _D:
        trigger, imbalance, crossover, overhead, gain = (
            True, 0.1, 0.5, 1.0, 0.0)

    mon.record(1.0, _D())
    assert not mon.aligned()


# ---------------------------------------------------------------------------
# registry primitives and the OpenMetrics parser
# ---------------------------------------------------------------------------

def test_log_buckets_spacing_and_validation():
    b = log_buckets(1e-2, 1e1, per_decade=3)
    assert b[0] == pytest.approx(1e-2)
    assert all(hi > lo for lo, hi in zip(b, b[1:]))
    assert 9 <= len(b) <= 11
    assert b == jobs.log_buckets(1e-2, 1e1, per_decade=3)
    for lo, hi in ((0.0, 1.0), (1.0, 1.0), (2.0, 1.0)):
        with pytest.raises(ValueError):
            log_buckets(lo, hi)
    with pytest.raises(ValueError):
        log_buckets(1.0, 10.0, per_decade=0)


def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("req_total", "requests", labels=("kind",))
    c.inc(kind="a")
    c.inc(2.0, kind="a")
    c.inc(kind="b")
    assert c.get(kind="a") == 3.0
    assert reg.value("req_total", kind="b") == 1.0
    g = reg.gauge("depth")
    g.set(7.0)
    g.inc(-2.0)
    assert g.get() == 5.0
    h = reg.histogram("lat", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    cum = h.cumulative(h._default)
    assert cum == sorted(cum) and cum[-1] == 4
    h2 = reg.histogram("edge", buckets=(1.0, 2.0))
    h2.observe(1.0)
    assert h2._default.counts[0] == 1


def test_registry_get_or_create_and_kind_conflict():
    reg = MetricsRegistry()
    a = reg.counter("x_total")
    assert reg.counter("x_total") is a
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")
    with pytest.raises(ValueError, match="increasing"):
        Histogram("bad", buckets=(2.0, 1.0))
    with pytest.raises(ValueError, match="bucket"):
        Histogram("empty", buckets=())
    with pytest.raises(ValueError, match="expected labels"):
        Counter("y_total", labels=("k",)).labels(wrong="v")


def test_merge_registries_tags_members():
    regs = []
    for k in range(2):
        reg = MetricsRegistry()
        reg.counter("done_total").inc(10 * (k + 1))
        h = reg.histogram("wait", buckets=(1.0, 10.0))
        h.observe(0.5)
        h.observe(5.0 * (k + 1))
        regs.append(reg)
    merged = merge_registries(regs, "member", ["m0", "m1"])
    assert merged.value("done_total", member="m1") == 20.0
    fams = parse_openmetrics(to_openmetrics(merged))
    assert {lbl["member"] for _, lbl, _ in fams["done"]["samples"]} == {
        "m0", "m1"}


@pytest.mark.parametrize("text", [
    "# TYPE a gauge\na 1\n",
    "# TYPE a gauge\na 1\n# EOF\nb 2\n",
    "# TYPE a gauge\n\na 1\n# EOF\n",
    "a 1\n# EOF\n",
    "# TYPE a counter\na 1\n# EOF\n",
    "# TYPE h histogram\nh_bucket 1\n# EOF\n",
    '# TYPE h histogram\nh_bucket{le="1"} 1\n# EOF\n',
    '# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="2"} 3\n'
    'h_bucket{le="+Inf"} 5\n# EOF\n',
    "# TYPE a gauge\na xyz\n# EOF\n",
    "# TYPE a gauge\n# TYPE a gauge\na 1\n# EOF\n",
], ids=["no-eof", "after-eof", "blank", "no-type", "counter-no-total",
        "bucket-no-le", "no-inf", "non-monotone", "bad-value", "dup-type"])
def test_openmetrics_parser_rejects_malformed_input(text):
    with pytest.raises(ValueError):
        parse_openmetrics(text)
    with pytest.raises(ValueError):
        jobs.parse_openmetrics(text)


def test_openmetrics_lint_cli(tmp_path, capsys):
    reg = MetricsRegistry()
    reg.counter("jobs_total", "jobs").inc(3)
    good = tmp_path / "good.txt"
    good.write_text(to_openmetrics(reg))
    assert lint_cli([str(good)]) == 0
    assert "OK" in capsys.readouterr().out
    bad = tmp_path / "bad.txt"
    bad.write_text("jobs_total 3\n")
    assert lint_cli([str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().err


def test_metrics_http_server_serves_scrape():
    reg = MetricsRegistry()
    reg.counter("jobs_total", "jobs").inc(3)
    with MetricsHTTPServer(lambda: to_openmetrics(reg), port=0) as srv:
        assert srv.url.startswith("http://127.0.0.1:")
        body = urllib.request.urlopen(srv.url).read().decode()
        assert parse_openmetrics(body)["jobs"]["type"] == "counter"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(srv.url.replace("/metrics", "/other"))
        assert err.value.code == 404


def test_merge_chrome_traces_applies_offsets():
    t0 = {"traceEvents": [{"name": "a", "ph": "i", "ts": 1e6, "pid": 1,
                           "tid": 0, "args": {}}], "otherData": {}}
    merged = merge_chrome_traces([t0, t0], ["x", "y"], offsets=[0.0, 2.0])
    assert sorted(e["ts"] for e in merged["traceEvents"]) == [1e6, 3e6]
    assert sorted(e["pid"] for e in merged["traceEvents"]) == [1, 17]
    assert merged == jobs.merge_chrome_traces([t0, t0], ["x", "y"],
                                              offsets=[0.0, 2.0])


# ---------------------------------------------------------------------------
# the decision sink
# ---------------------------------------------------------------------------

class _FlakySink:
    """Raises on every other call of every hook."""

    def __init__(self):
        self.calls = 0

    def _flaky(self, *a):
        self.calls += 1
        if self.calls % 2:
            raise RuntimeError("flaky sink")

    place = migrate = evict = complete = trigger = alert = _flaky


def test_events_backend_registry_matches_summary():
    r = lab.run(_scenario(lab, lab.ObsSpec(probe_every=1.0, metrics=True)))
    snap = r.extras["obs"]["metrics"]
    shared = 0
    for key, v in r.metrics.items():
        if "sched_" + key not in snap or v is None or isinstance(v, bool):
            continue
        assert snap["sched_" + key]["samples"][""] == pytest.approx(v), key
        shared += 1
    assert shared >= 10
    assert snap["sched_tasks_completed_total"]["samples"][""] \
        == r.metrics["completed"]
    by_kind = snap["sched_decisions_total"]["samples"]
    assert by_kind["kind=complete"] == r.metrics["completed"]


def test_flaky_sink_does_not_corrupt_engine_state():
    sc = _scenario(lab)
    clean = lab.run(sc).metrics
    rt, wl, ins, (failures, joins, resizes) = \
        backends.build_events_runtime(sc)
    flaky = _FlakySink()
    rt._sink = flaky
    rt.schedule_faults(failures=failures, joins=joins, resizes=resizes)
    rt.schedule_workload(wl)
    rt.drain()
    assert rt.sink_errors == (flaky.calls + 1) // 2 > 0
    assert rt.metrics.summary() == dict(clean)


def test_sink_errors_surface_in_the_registry():
    rt, wl, ins, _ = backends.build_events_runtime(_scenario(lab))
    collector = RegistryCollector()
    rt._sink = FanoutSink([_FlakySink(), collector])
    collector.bind(rt)
    rt.schedule_workload(wl)
    rt.drain()
    collector.refresh()
    reg = collector.registry
    assert reg.value("sched_sink_errors_total") == rt.sink_errors > 0
    assert reg.value("sched_tasks_completed_total") == rt.metrics.completed


def test_attach_collector_is_get_or_create():
    rt = ClusterRuntime((2.0, 1.0, 1.0, 0.5), "jsq")
    rt.schedule_workload(make_workload("poisson", horizon=10.0, seed=1,
                                       rate=2.0))
    rt.advance(until=5.0)
    first = attach_collector(rt)
    assert "sched_queued_tasks" in parse_openmetrics(first.scrape())
    rt.drain()
    assert attach_collector(rt) is first
    fams = parse_openmetrics(first.scrape())
    assert fams["sched_completed"]["samples"][0][2] == rt.metrics.completed


# ---------------------------------------------------------------------------
# anomaly detection
# ---------------------------------------------------------------------------

def test_ewma_mad_scoring():
    em = EwmaMad(alpha=0.25, window=16, warmup=4, min_scale=0.5)
    assert em.update(0.0) == 0.0
    for _ in range(10):
        z = em.update(0.0)
    assert z == 0.0
    for _ in range(20):
        z = em.update(10.0)
    assert z > 6.0
    assert em.update(float("nan")) == 0.0
    for bad in (dict(alpha=0.0), dict(warmup=1), dict(min_scale=-1.0)):
        with pytest.raises(ValueError):
            EwmaMad(**bad)


def test_anomaly_flags_queue_ramp_before_trigger_fires():
    r = lab.run(_scenario(lab, lab.ObsSpec(probe_every=0.5, metrics=True,
                                           anomaly=True),
                          rate=40.0, horizon=20.0, period=100.0,
                          faults=False))
    obs = r.extras["obs"]
    fires = [e["t"] for e in obs["trigger"]["events"] if e["fired"]]
    growth = [a for a in obs["alerts"] if a["kind"] == "queue_growth"]
    assert growth
    assert not fires or growth[0]["t"] < fires[0]
    snap = obs["metrics"]
    assert snap["obs_alerts_total"]["samples"]["kind=queue_growth"] \
        == len(growth)


def test_anomaly_balanced_control_stays_silent():
    r = lab.run(_scenario(lab, lab.ObsSpec(probe_every=0.5, anomaly=True),
                          rate=3.0, horizon=30.0, faults=False))
    assert r.extras["obs"]["alerts"] == []


def test_anomaly_trigger_storm_and_cooldown():
    mon = AnomalyMonitor(storm_window=10.0, storm_count=3, cooldown=5)
    out = []
    for i in range(6):
        out += mon.observe_trigger(float(i), True)
    assert [a["kind"] for a in out] == ["trigger_storm"]
    assert out[0]["fires"] == 4
    mon2 = AnomalyMonitor(storm_window=10.0, storm_count=3)
    assert all(mon2.observe_trigger(float(i), False) == []
               for i in range(10))
    mon3 = AnomalyMonitor(storm_window=100.0, storm_count=1, cooldown=4)
    raised = []
    for i in range(10):
        raised += mon3.observe_trigger(float(i), True)
    assert 1 < len(raised) < 10


def test_anomaly_spec_validation():
    with pytest.raises(ValueError, match="probe"):
        lab.ObsSpec(anomaly=True)
    with pytest.raises(ValueError, match="latency_sample"):
        lab.ObsSpec(latency_sample=0)
    with pytest.raises(ValueError, match="drift_margin"):
        AnomalyMonitor(drift_margin=1.5)
    with pytest.raises(ValueError, match="k must"):
        AnomalyMonitor(k=0.0)
    with pytest.raises(ValueError, match="probe"):
        ClusterRuntime((1.0, 1.0), "jsq", anomaly=AnomalyMonitor())
