"""The port's task-dependency DAGs (``repro_torch.graphs``) held against the
JAX package's ``repro.graphs`` on the CPU.

Both packages run the same numpy calls in the same order, so equality is
exact: every generator's ``DagSpec`` arrays and topological utilities, the
validation messages, the DAG scenarios' ``Metrics.summary()`` and
``work_census()`` on the event engine, and the batched and legacy backends'
refusals.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import graphs as jgraphs  # noqa: E402
from repro import lab as jlab  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro import traces as jtraces  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch import lab  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402
from repro_torch import traces  # noqa: E402

KINDS = sorted(jgraphs.DAG_KINDS)
POWERS = (2.0, 1.0, 3.0, 1.5, 2.5, 1.0)


def _assert_dag_equal(got, want):
    assert type(got).__module__.startswith("repro_torch.")
    assert got.m == want.m and got.k == want.k
    for f in ("child", "parent", "out_size"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.to_dict() == want.to_dict()
    if got.m:
        np.testing.assert_array_equal(got.topo, want.topo)
        np.testing.assert_array_equal(got.levels(), want.levels())
        assert got.depth() == want.depth()
        assert got.width() == want.width()
        assert got.critical_path() == want.critical_path()
        assert got.parents_of() == want.parents_of()
        assert got.children_of() == want.children_of()


def test_the_port_has_the_references_kinds():
    assert sorted(graphs.DAG_KINDS) == KINDS
    assert graphs.DagSpec is traces.DagSpec


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [0, 1, 2, 3, 7, 40, 257])
@pytest.mark.parametrize("seed", [0, 1, 13])
def test_make_dag_equals_reference(kind, m, seed):
    spec = {"kind": kind, "out_size": 12.5}
    _assert_dag_equal(graphs.make_dag(spec, m, seed),
                      jgraphs.make_dag(spec, m, seed))


@pytest.mark.parametrize("spec", [
    {"kind": "fanin_fanout", "fan": 2},
    {"kind": "fanin_fanout", "fan": 9, "out_size": 0.0},
    {"kind": "random", "p": 0.6, "max_parents": 5, "out_size": 3.0},
    {"kind": "random", "p": 1.0, "max_parents": 2},
    {"kind": "random", "p": 0.0},
    {"edges": [[1, 0], [2, 0], [3, 1], [3, 2]], "out_size": [1, 2, 3, 4]},
    {"edges": [], "m": 5},
], ids=["fan2", "fan9", "random-dense", "random-p1", "random-p0",
        "explicit", "explicit-edgeless"])
def test_generator_knobs_and_explicit_edges_equal_reference(spec):
    for seed in (0, 5):
        m = 4 if "edges" in spec and spec["edges"] else 60
        if spec.get("m"):
            m = spec["m"]
        _assert_dag_equal(graphs.make_dag(dict(spec), m, seed),
                          jgraphs.make_dag(dict(spec), m, seed))


def test_dag_bounds_equal_reference():
    for kind in KINDS:
        jd = jgraphs.make_dag({"kind": kind, "out_size": 4.0}, 30, 3)
        d = graphs.make_dag({"kind": kind, "out_size": 4.0}, 30, 3)
        rng = np.random.default_rng(7)
        works = rng.uniform(0.5, 5.0, 30)
        t_arrive = np.sort(rng.uniform(0.0, 10.0, 30))
        assert d.critical_path(works) == jd.critical_path(works)
        assert (d.cp_lower_bound(works, POWERS)
                == jd.cp_lower_bound(works, POWERS))
        assert (d.cp_lower_bound(works, POWERS, t_arrive)
                == jd.cp_lower_bound(works, POWERS, t_arrive))
        keep = np.flatnonzero(rng.random(30) < 0.6)
        _assert_dag_equal(d.select(keep), jd.select(keep))
        _assert_dag_equal(graphs.DagSpec.from_dict(jd.to_dict()), jd)


def _raises_same(make):
    """Call ``make(pkg)`` for both packages; both must raise the same
    exception type with the same message."""
    with pytest.raises(Exception) as want:
        make(jgraphs)
    with pytest.raises(want.type) as got:
        make(graphs)
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("make", [
    lambda g: g.DagSpec(child=[1], parent=[1], m=3),
    lambda g: g.DagSpec(child=[1, 2, 0], parent=[0, 1, 2], m=3),
    lambda g: g.DagSpec(child=[1, 1], parent=[0, 0], m=2),
    lambda g: g.DagSpec(child=[5], parent=[0], m=3),
    lambda g: g.DagSpec(child=[1], parent=[-1], m=3),
    lambda g: g.DagSpec(child=[1, 2], parent=[0], m=3),
    lambda g: g.DagSpec(out_size=[1.0, -2.0], m=2),
    lambda g: g.DagSpec(out_size=[1.0, np.inf], m=2),
    lambda g: g.DagSpec(out_size=[1.0, 2.0, 3.0], m=2),
    lambda g: g.make_dag({"kind": "tree"}, 4, 0),
    lambda g: g.make_dag([("kind", "chain")], 4, 0),
    lambda g: g.make_dag({"edges": [[1, 0]], "m": 9}, 4, 0),
    lambda g: g.make_dag({"kind": "chain", "fan": 3}, 4, 0),
    lambda g: g.make_dag({"kind": "chain"}, 4, 0).critical_path([1.0]),
    lambda g: g.make_dag({"kind": "chain"}, 4, 0).cp_lower_bound(
        [1.0, 2.0], (1.0,)),
], ids=["self-loop", "cycle", "duplicate", "out-of-range", "negative",
        "ragged", "negative-size", "inf-size", "size-count", "unknown-kind",
        "not-a-dict", "explicit-m", "bad-knob", "cp-works", "bound-works"])
def test_validation_messages_equal_reference(make):
    _raises_same(make)


def test_cycle_message_names_the_cycle():
    msg = _raises_same(lambda g: g.DagSpec(child=[1, 2, 0], parent=[0, 1, 2],
                                           m=3))
    assert msg.startswith("dag has a cycle:") and "->" in msg


# ---------------------------------------------------------------------------
# the event engine over DAG workloads
# ---------------------------------------------------------------------------

def _dag_trace(pkg_traces, pkg_graphs, m, spec, seed):
    rng = np.random.default_rng(seed)
    t_arrive = np.sort(rng.uniform(0.0, 15.0, m))
    works = rng.uniform(0.5, 4.0, m)
    packets = rng.uniform(1.0, 8.0, m)
    return pkg_traces.TraceSchema(
        t_arrive=t_arrive, works=works, packets=packets,
        dag=pkg_graphs.make_dag(spec, m, seed))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("policy", ["psts", "locality", "jsq",
                                    "arrival_only"])
def test_engine_runs_dag_workloads_as_the_reference(kind, policy):
    spec = {"kind": kind, "out_size": 16.0}
    kw = dict(trigger_period=1.0, link_bandwidth=8.0, seed=3)
    failures, joins = [(4.0, 1)], [(9.0, 1)]
    jr = jrt.ClusterRuntime(POWERS, policy, **kw)
    jm = jr.run(_dag_trace(jtraces, jgraphs, 60, spec, 2),
                failures=failures, joins=joins)
    pr = prt.ClusterRuntime(POWERS, policy, **kw)
    pm = pr.run(_dag_trace(traces, graphs, 60, spec, 2),
                failures=failures, joins=joins)
    assert pm.summary() == jm.summary()
    assert pr.work_census() == jr.work_census()
    assert pm.completed == pm.arrived == 60


def _scenario(pkg, dag, **overrides):
    fields = dict(
        cluster=pkg.ClusterSpec(powers=POWERS, link_bandwidth=8.0,
                                bandwidth=256.0),
        workload=pkg.WorkloadSpec(process="poisson", horizon=30.0,
                                  work_mean=3.0, params={"rate": 3.0},
                                  dag=dag),
        policy=pkg.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.1}),
        seed=4)
    fields.update(overrides)
    return pkg.Scenario(**fields)


def _both(dag, **overrides):
    jsc = _scenario(jlab, dag, **overrides)
    return jsc, lab.Scenario.from_json(jsc.to_json())


@pytest.mark.parametrize("dag", [
    {"kind": "chain", "out_size": 4.0},
    {"kind": "diamond"},
    {"kind": "fanin_fanout", "fan": 3, "out_size": 16.0},
    {"kind": "random", "p": 0.4, "out_size": 8.0},
], ids=["chain", "diamond", "fanin_fanout", "random"])
@pytest.mark.parametrize("policy", ["psts", "locality"])
def test_dag_scenarios_on_events_equal_reference(dag, policy):
    jsc, sc = _both(dag, policy=jlab.PolicySpec(
        policy, trigger_period=1.0,
        params={"floor": 0.1} if policy == "psts" else {}))
    assert sc.fingerprint() == jsc.fingerprint()
    got = lab.run(sc)
    want = jlab.run(jsc)
    assert got.to_dict() == want.to_dict()
    census = got.extras["work_census"]
    assert census["conservation_gap"] < 1e-9
    assert got["completed"] == got["arrived"]
    # the realized workload carries the same DAG in both packages
    _assert_dag_equal(sc.workload.materialize(sc.seed).dag,
                      jsc.workload.materialize(jsc.seed).dag)


def test_dag_seed_sweep_is_an_ensemble_as_in_the_reference():
    jsc, sc = _both({"kind": "random", "p": 0.5})
    got = lab.sweep(base=sc, grid={"seed": range(3)})
    want = jlab.sweep(base=jsc, grid={"seed": range(3)})
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert {r.backend for r in got} == {"events"}


@pytest.mark.parametrize("dag", [
    {"kind": "chain"},
    {"kind": "tree"},
    {"edges": [[1, 0]], "m": 9999},
    {"kind": "random", "q": 0.3},
], ids=["chain", "unknown-kind", "explicit-m", "bad-knob"])
def test_dag_eligibility_equals_reference(dag):
    def spec(pkg):
        return pkg.Scenario(cluster=pkg.ClusterSpec(powers=(1.0, 2.0)),
                            workload=pkg.WorkloadSpec(horizon=5.0, dag=dag))
    try:
        jsc = spec(jlab)
    except ValueError as exc:
        # the generator kind is checked where the spec is declared
        with pytest.raises(ValueError) as got:
            spec(lab)
        assert str(got.value) == str(exc)
        return
    sc = spec(lab)
    for name in ("events", "batched", "legacy"):
        assert (lab.get_backend(name).eligible(sc)
                == jlab.get_backend(name).eligible(jsc)), name
    assert lab.get_backend("batched").eligible(sc) is not None


def test_batched_refuses_a_dag_with_the_references_reason():
    jsc, sc = _both({"kind": "chain"})
    want = jlab.get_backend("batched").eligible(jsc)
    assert "no per-task identity" in want
    with pytest.raises(lab.BackendError) as got:
        lab.run(sc, backend="batched", device="cpu")
    assert str(got.value) == f"backend 'batched': {want}"


def test_trace_dependency_edges_equal_reference(tmp_path):
    """A normalized trace whose sidecar carries ``deps``: parsed, replayed
    and refused by batched as in the JAX package."""
    csv = tmp_path / "deps.csv"
    side = tmp_path / "deps.json"
    rng = np.random.default_rng(0)
    rows = [f"{t:.6f},{w:.6f},2.0" for t, w in
            zip(np.sort(rng.uniform(0, 8, 12)), rng.uniform(1, 3, 12))]
    csv.write_text("\n".join(rows) + "\n")
    side.write_text('{"deps": [[1, 0], [2, 1], [5, 3], [5, 4], [11, 2]], '
                    '"out_size": [[0, 32.0], [3, 8.0]]}')

    def spec(pkg):
        return pkg.Scenario(
            cluster=pkg.ClusterSpec(powers=POWERS, link_bandwidth=4.0),
            workload=pkg.WorkloadSpec(
                trace=pkg.TraceRef(path=str(csv), format="csv",
                                   params={"constraints_path": str(side)}),
                horizon=None),
            policy=pkg.PolicySpec("locality"))
    jsc, sc = spec(jlab), spec(lab)
    assert sc.fingerprint() == jsc.fingerprint()
    _assert_dag_equal(sc.workload.materialize(0).dag,
                      jsc.workload.materialize(0).dag)
    assert lab.run(sc).to_dict() == jlab.run(jsc).to_dict()
    for name in ("batched", "legacy"):
        assert (lab.get_backend(name).eligible(sc)
                == jlab.get_backend(name).eligible(jsc))
    # a trace's own edges and WorkloadSpec(dag=...) do not mix
    both = sc.updated({"workload.dag": {"kind": "chain"}})
    jboth = jsc.updated({"workload.dag": {"kind": "chain"}})
    assert (lab.get_backend("events").eligible(both)
            == jlab.get_backend("events").eligible(jboth))
    assert "already carries dependency edges" in (
        lab.get_backend("events").eligible(both))


def test_trace_scale_refuses_dag_traces_as_the_reference():
    def make(pkg_traces, pkg_graphs):
        tr = _dag_trace(pkg_traces, pkg_graphs, 5, {"kind": "chain"}, 0)
        return pkg_traces.trace_scale(tr, 2.0, seed=0)
    with pytest.raises(ValueError) as want:
        make(jtraces, jgraphs)
    with pytest.raises(ValueError) as got:
        make(traces, graphs)
    assert str(got.value) == str(want.value)
