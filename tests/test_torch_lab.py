"""``repro_torch.lab`` held against the JAX package's ``repro.lab`` on the
batched backend: the same Scenario gives the same fingerprint, the same
eligibility reason and, on the CPU, the same metrics at rtol 1e-6."""

import dataclasses
from pathlib import Path

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import lab as jlab  # noqa: E402
from repro_torch import lab  # noqa: E402
from repro_torch.runtime import VectorConfig, to_tensors  # noqa: E402
from repro_torch.runtime.vector_backend import _simulate_batch_torch  # noqa: E402

POWERS = (3.0, 1.0, 7.0, 2.0, 5.0, 9.0, 4.0, 6.0,
          2.0, 8.0, 1.0, 5.0, 3.0, 6.0, 4.0, 7.0)
TRACE = Path(__file__).parent / "data" / "tiny_trace.csv"
FLOAT_METRICS = ("makespan", "mean_response", "p99_response", "moved_units",
                 "moved_packets", "admitted_work")


def _scenario(pkg, **overrides):
    fields = dict(
        cluster=pkg.ClusterSpec(powers=POWERS, bandwidth=256.0),
        workload=pkg.WorkloadSpec(process="poisson", horizon=60.0,
                                  work_mean=6.0, params={"rate": 6.0}),
        policy=pkg.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.1}),
        seed=0)
    fields.update(overrides)
    return pkg.Scenario(**fields)


def _both(**overrides):
    """The same scenario declared in each package (from one JSON text)."""
    sc = _scenario(jlab, **overrides)
    return sc, lab.Scenario.from_json(sc.to_json())


def _assert_results_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.fingerprint == w.fingerprint
        assert g.backend == w.backend == "batched"
        assert g.backend_options == w.backend_options
        assert g.extras.keys() == w.extras.keys()
        for k, v in w.metrics.items():
            if k in FLOAT_METRICS and v is not None:
                np.testing.assert_allclose(g.metrics[k], v, rtol=1e-6,
                                           err_msg=k)
            else:
                assert g.metrics[k] == v, k


def test_fingerprints_and_json_round_trip_match():
    jsc, sc = _both(faults=jlab.FaultSpec(failures=((30.0, 2),),
                                          joins=((50.0, 2),)))
    assert sc.fingerprint() == jsc.fingerprint()
    assert sc.to_dict() == jsc.to_dict()
    assert lab.Scenario.from_json(sc.to_json()) == sc
    grid = {"seed": range(3), "policy.params.floor": [0.05, 0.1]}
    assert ([s.fingerprint() for s in lab.expand_grid(sc, grid)]
            == [s.fingerprint() for s in jlab.expand_grid(jsc, grid)])


@pytest.mark.parametrize("fifo", [False, True])
def test_sweep_auto_dispatches_and_matches_repro_lab(fifo):
    jsc, sc = _both()
    grid = {"seed": range(9)}
    got = lab.sweep(base=sc, grid=grid, fifo_dispatch=fifo, device="cpu")
    want = jlab.sweep(base=jsc, grid=grid, fifo_dispatch=fifo)
    _assert_results_match(got, want)
    assert len({r.fingerprint for r in got}) == 9


def test_run_with_faults_and_probe_matches():
    overrides = dict(faults=jlab.FaultSpec(failures=((20.0, 5),),
                                           joins=((40.0, 5),),
                                           resizes=((10.0, 2, 0.5),)),
                     obs=jlab.ObsSpec(probe_every=1.0))
    jsc, sc = _both(**overrides)
    got = lab.run(sc, backend="batched", device="cpu")
    want = jlab.run(jsc, backend="batched")
    _assert_results_match([got], [want])
    g, w = got.extras["obs"], want.extras["obs"]
    assert g["probes"]["fires"] == w["probes"]["fires"]
    np.testing.assert_allclose(g["probes"]["node_load"],
                               w["probes"]["node_load"], rtol=1e-6,
                               atol=1e-9)
    assert g["trigger"]["summary"] == w["trigger"]["summary"]


def test_trace_path_replay_matches():
    jsc, sc = _both(workload=jlab.WorkloadSpec(trace_path=str(TRACE),
                                               horizon=None))
    got = lab.run(sc, backend="batched", dt=0.5, device="cpu")
    want = jlab.run(jsc, backend="batched", dt=0.5)
    _assert_results_match([got], [want])
    assert got["completed"] == 8


@pytest.mark.parametrize("overrides", [
    dict(policy=jlab.PolicySpec("jsq")),
    dict(policy=jlab.PolicySpec("psts", params={"flor": 0.9})),
    dict(faults=jlab.FaultSpec(joins=((10.0, 2),))),
    dict(faults=jlab.FaultSpec(failures=tuple((10.0, n) for n in range(16)))),
    dict(faults=jlab.FaultSpec(failures=((10.0, 99),))),
    dict(workload=jlab.WorkloadSpec(dag={"kind": "chain"})),
    dict(workload=jlab.WorkloadSpec(trace_path="/nonexistent/trace.csv")),
    dict(),
], ids=["policy", "typo", "join", "outage", "range", "dag", "trace", "ok"])
def test_eligibility_reasons_match(overrides):
    jsc, sc = _both(**overrides)
    assert (lab.get_backend("batched").eligible(sc)
            == jlab.get_backend("batched").eligible(jsc))


def test_reference_compile_output_runs_through_the_port_engine():
    """Data carried across: repro's lowering (numpy arrays + its
    VectorConfig) through ``to_tensors`` into the port's engine."""
    jsc = _scenario(jlab, faults=jlab.FaultSpec(failures=((15.0, 9),)))
    scs = [jsc.updated({"seed": s}) for s in range(4)]
    backend = jlab.get_backend("batched")
    slot, works, powers, jcfg, scale = backend.compile(
        scs, backend.default_dt, fifo_dispatch=True)
    cfg = VectorConfig(**dataclasses.asdict(jcfg))
    out = _simulate_batch_torch(*to_tensors(slot, works, powers, scale,
                                            device="cpu"), cfg)
    want = jlab.sweep(scs, backend="batched", fifo_dispatch=True)
    np.testing.assert_allclose(out[1].numpy(),
                               [r["p99_response"] for r in want], rtol=1e-6)
    np.testing.assert_allclose(out[0].numpy(),
                               [r["mean_response"] for r in want], rtol=1e-6)
    # and the port's own lowering gives the same arrays and config
    port = lab.get_backend("batched").compile(
        [lab.Scenario.from_json(s.to_json()) for s in scs],
        backend.default_dt, fifo_dispatch=True)
    for a, b in zip(port[:3], (slot, works, powers)):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(port[3]) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(port[4], scale)


def test_unported_parts_say_so():
    sc = _scenario(lab)
    # the event engine (the default) and the paper simulator run ...
    assert lab.run(sc).backend == "events"
    assert lab.run(sc, backend="legacy").backend == "legacy"
    # ... only the online backend still waits for a later slice; the
    # federated one registers on first use and refuses a single scenario
    # with the JAX package's reason
    with pytest.raises(lab.BackendError, match="not ported"):
        lab.run(sc, backend="online")
    with pytest.raises(lab.BackendError, match="runs Federation specs"):
        lab.run(sc, backend="federated")
    assert sorted(lab.BACKENDS) == ["batched", "events", "federated",
                                    "legacy"]
    # device= reaches the batched backend alone: a small sweep runs on the
    # host engine, a uniform one of 8 seeds on the batched backend, and an
    # explicit host backend refuses the option as the JAX package's does
    small = lab.sweep(base=sc, grid={"seed": range(3)}, device="cpu")
    assert [r.backend for r in small] == ["events"] * 3
    large = lab.sweep(base=sc, grid={"seed": range(8)}, device="cpu")
    assert {r.backend for r in large} == {"batched"}
    for name in ("events", "legacy"):
        with pytest.raises(TypeError, match="takes no options"):
            lab.run(sc, backend=name, device="cpu")
    # trace references, node attribute tables and DAG workloads work now,
    # with the JAX package's validation
    with pytest.raises(ValueError, match="unknown trace format"):
        lab.TraceRef(path="x.csv", format="nope")
    ref = lab.TraceRef(path=str(TRACE))
    assert ref.load(0).m == jlab.TraceRef(path=str(TRACE)).load(0).m == 8
    assert lab.ClusterSpec(n_nodes=2, attrs={"rack": (0, 1)}
                           ).resolve_attrs() == {"rack": (0.0, 1.0)}
    with pytest.raises(ValueError, match="2 nodes"):
        lab.ClusterSpec(n_nodes=2, attrs={"rack": (0, 1, 2)})
    dag = _scenario(lab, workload=lab.WorkloadSpec(dag={"kind": "chain"}))
    wl = dag.workload.materialize(0)
    assert wl.has_dag and wl.dag.m == wl.m


def test_batched_defaults_are_psts_policy_defaults():
    from repro_torch.runtime.policies import PstsPolicy
    sc = _scenario(lab, policy=lab.PolicySpec("psts"))
    backend = lab.get_backend("batched")
    *_, cfg, _ = backend.compile([sc], backend.default_dt)
    for k in ("floor", "p", "q", "t_task", "packets_per_step"):
        assert getattr(cfg, k) == getattr(PstsPolicy(), k), k
    assert cfg.floor == 0.05


def test_run_many_rejects_nonuniform_batch():
    mixed = [_scenario(lab),
             _scenario(lab, workload=lab.WorkloadSpec(horizon=30.0,
                                                      params={"rate": 6.0}))]
    with pytest.raises(lab.BackendError, match="identical except"):
        lab.get_backend("batched").run_many(mixed, device="cpu")
