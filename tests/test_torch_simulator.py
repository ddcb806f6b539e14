"""The port's static paper simulator (``repro_torch.core.simulator``) and the
lab's ``legacy`` backend, held against the JAX package's on the CPU.

Both packages draw the same numbers from the same seed and run the same
numpy operations, so ``simulate``, ``sweep_nodes`` and ``crossover_table``
must equal the reference's field for field, and the legacy backend's
``RunResult.to_dict()`` must equal ``repro.lab``'s, eligibility reasons
included. The paper-trend cases of ``tests/test_core_simulator.py`` run on
the port as well.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import dataclasses
from dataclasses import replace

import numpy as np
import pytest

from repro import core as jcore
from repro import lab as jlab
from repro_torch import lab
from repro_torch.core import (
    SimConfig,
    SimResult,
    crossover_table,
    simulate,
    sweep_nodes,
)

POWERS = (3.0, 1.0, 7.0, 2.0, 5.0, 9.0, 4.0, 6.0,
          2.0, 8.0, 1.0, 5.0, 3.0, 6.0, 4.0, 7.0)


def _fields(r) -> dict:
    """Every field and derived property of a SimResult (config as a dict)."""
    d = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    d["config"] = dataclasses.asdict(r.config)
    d["speedup"] = r.speedup
    d["crossover"] = r.crossover
    return d


def _jcfg(cfg: SimConfig):
    return jcore.SimConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# exactly equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    SimConfig(),
    SimConfig(n_nodes=16, d=4, seed=0),
    SimConfig(n_nodes=32, d=5, work_dist="poisson", seed=1),
    SimConfig(n_nodes=12, d=2, m_tasks=500, skew=0.3, seed=7),
    SimConfig(n_nodes=4, d=1, powers=(1.0, 2.0, 3.0, 4.0), p=1e-3,
              packets_per_step=8.0, seed=3),
], ids=["paper", "d4", "poisson", "skew", "explicit-powers"])
def test_simulate_matches_reference(cfg):
    got = simulate(cfg)
    want = jcore.simulate(_jcfg(cfg))
    assert _fields(got) == _fields(want)


def test_sweep_nodes_and_crossover_table_match_reference():
    cfg = SimConfig(seed=5, m_tasks=1000)
    nodes = (2, 4, 8, 16, 32, 64)
    for d in (None, 1):
        got = sweep_nodes(cfg, nodes=nodes, d=d)
        want = jcore.sweep_nodes(_jcfg(cfg), nodes=nodes, d=d)
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert (crossover_table(cfg, nodes=nodes)
            == jcore.crossover_table(_jcfg(cfg), nodes=nodes))


def test_bad_inputs_raise_like_reference():
    with pytest.raises(ValueError, match="work distribution"):
        simulate(SimConfig(work_dist="exponential"))
    with pytest.raises(ValueError, match="powers has 2 entries"):
        simulate(SimConfig(n_nodes=3, powers=(1.0, 2.0)))
    assert SimConfig().with_d(3) == replace(SimConfig(), d=3)
    assert [f.name for f in dataclasses.fields(SimResult)] == [
        f.name for f in dataclasses.fields(jcore.SimResult)]


# ---------------------------------------------------------------------------
# the paper's trends (tests/test_core_simulator.py's cases, on the port)
# ---------------------------------------------------------------------------

def test_simulate_balances():
    r = simulate(SimConfig(n_nodes=16, d=4, seed=0))
    assert r.imbalance_after < r.imbalance_before
    assert r.makespan_after <= r.makespan_before
    assert r.imbalance_after < 0.05  # near-perfect at 4000 tasks


@pytest.mark.parametrize("dist", ["uniform", "poisson"])
def test_both_paper_distributions(dist):
    r = simulate(SimConfig(n_nodes=32, d=5, work_dist=dist, seed=1))
    assert r.speedup > 1.0
    assert r.moved_tasks > 0


def test_fig4_overhead_decreases_with_nodes():
    rows = sweep_nodes(SimConfig(seed=2), d=1)
    overheads = [r.overhead for r in rows]
    assert overheads == sorted(overheads, reverse=True)


def test_fig5_higher_dim_cheaper_than_dim1():
    cfg = SimConfig(seed=3)
    for n in (8, 16, 32, 64):
        r1 = simulate(replace(cfg, n_nodes=n, d=1))
        ro = sweep_nodes(cfg, nodes=(n,))[0]
        assert ro.overhead < r1.overhead


def test_fig6_speedup_above_one_and_decreasing():
    sps = np.mean(
        [[r.speedup for r in sweep_nodes(SimConfig(seed=s),
                                         nodes=(8, 16, 32, 64))]
         for s in range(4)], axis=0)
    assert all(s > 1.0 for s in sps)
    assert sps[0] > sps[-1]
    assert sps[1] > sps[-1]


def test_table6_crossover_lower_at_higher_dim():
    rows = crossover_table(SimConfig(seed=5), nodes=(4, 8, 16, 32, 64))
    for row in rows:
        assert row["crossover_dopt"] <= row["crossover_d1"] * 1.0001
        assert row["d_opt"] >= 2


def test_deterministic_given_seed():
    a = simulate(SimConfig(seed=42))
    b = simulate(SimConfig(seed=42))
    assert a.makespan_after == b.makespan_after
    assert a.moved_tasks == b.moved_tasks


# ---------------------------------------------------------------------------
# the legacy backend through repro_torch.lab
# ---------------------------------------------------------------------------

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
    sc = _scenario(jlab, **overrides)
    return sc, lab.Scenario.from_json(sc.to_json())


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(policy=jlab.PolicySpec("psts", params={"p": 0.05, "q": 0.01})),
    dict(workload=jlab.WorkloadSpec(process="bursty", horizon=60.0,
                                    work_dist="poisson", work_mean=5.0,
                                    params={"rate_lo": 1.0,
                                            "rate_hi": 8.0})),
    dict(workload=jlab.WorkloadSpec(m_tasks=777, work_mean=3.0)),
    dict(cluster=jlab.ClusterSpec(n_nodes=24, power_seed=4, d=2)),
    dict(obs=jlab.ObsSpec(probe_every=1.0)),
], ids=["plain", "cost", "bursty", "m_tasks", "sampled-powers", "obs"])
def test_legacy_run_matches_reference(overrides):
    jsc, sc = _both(**overrides)
    got = lab.run(sc, backend="legacy")
    want = jlab.run(jsc, backend="legacy")
    assert got.to_dict() == want.to_dict()
    assert got.backend == "legacy"
    assert got.extras["crossover"] > 0
    assert got.metrics["completed"] == got.metrics["arrived"]


@pytest.mark.parametrize("overrides", [
    dict(faults=jlab.FaultSpec(failures=((10.0, 2),))),
    dict(policy=jlab.PolicySpec("jsq")),
    dict(policy=jlab.PolicySpec("psts", params={"flor": 0.9})),
    dict(workload=jlab.WorkloadSpec(trace_path="/nonexistent/trace.csv")),
    dict(workload=jlab.WorkloadSpec(dag={"kind": "chain"})),
    dict(),
], ids=["faults", "foreign-policy", "typo", "trace", "dag", "ok"])
def test_legacy_eligibility_reasons_match(overrides):
    jsc, sc = _both(**overrides)
    want = jlab.get_backend("legacy").eligible(jsc)
    assert lab.get_backend("legacy").eligible(sc) == want
    if want is not None:
        with pytest.raises(lab.BackendError, match="backend 'legacy'"):
            lab.run(sc, backend="legacy")


def test_legacy_backend_takes_no_options():
    with pytest.raises(TypeError, match="takes no options"):
        lab.run(_scenario(lab), backend="legacy", device="cpu")
