"""The numpy modules the port carries over (core, workloads, metrics,
policies) and its torch scans, held against the JAX package's originals on
the same inputs."""

import numpy as np
import pytest
import torch

from repro.core import cost_model as jcost
from repro.core import hypergrid as jgrid
from repro.core import pslb as jpslb
from repro.core import scan as jscan
from repro.core import trigger as jtrig
from repro.runtime import metrics as jmetrics
from repro.runtime import policies as jpol
from repro.runtime import workload as jwl
from repro_torch.core import cost_model, hypergrid, pslb, scan, trigger
from repro_torch.runtime import metrics, policies, workload


@pytest.mark.parametrize("shape,axis", [((7,), -1), ((3, 9), 0), ((3, 9), 1),
                                        ((0,), -1)])
def test_scans_match(shape, axis):
    a = np.random.default_rng(0).integers(0, 9, size=shape).astype(np.float64)
    np.testing.assert_array_equal(scan.exclusive_scan_np(a, axis),
                                  jscan.exclusive_scan_np(a, axis))
    np.testing.assert_array_equal(scan.inclusive_scan_np(a, axis),
                                  jscan.inclusive_scan_np(a, axis))
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(scan.exclusive_scan(t, axis).numpy(),
                                  np.asarray(jscan.exclusive_scan(a, axis)))
    np.testing.assert_array_equal(scan.inclusive_scan(t, axis).numpy(),
                                  np.asarray(jscan.inclusive_scan(a, axis)))


def test_segment_positions_match():
    onehot = np.eye(4, dtype=np.int32)[np.random.default_rng(1).integers(
        0, 4, size=30)]
    np.testing.assert_array_equal(
        scan.segment_positions(torch.from_numpy(onehot)).numpy(),
        np.asarray(jscan.segment_positions(onehot)))


@pytest.mark.parametrize("n,d", [(1, None), (13, None), (16, 2), (100, 3)])
def test_hypergrid_cost_and_trigger_match(n, d):
    rng = np.random.default_rng(n)
    powers = rng.integers(1, 10, size=n).astype(float)
    g, jg = hypergrid.embed(powers, d), jgrid.embed(powers, d)
    assert g.dims == jg.dims
    np.testing.assert_array_equal(g.powers, jg.powers)
    assert cost_model.execution_time(g.dims, g.n_active, 500, 1e-3, 1e-4, 30.0,
                                      64.0) == jcost.execution_time(
        jg.dims, jg.n_active, 500, 1e-3, 1e-4, 30.0, 64.0)
    assert cost_model.optimal_cost(n, 0.2, 0.1) == jcost.optimal_cost(
        n, 0.2, 0.1)
    loads = np.concatenate([rng.uniform(0, 50, size=n),
                            np.zeros(g.capacity - n)])
    dec = trigger.CrossoverTrigger(g, p=1e-3, q=1e-4, floor=0.05).evaluate(
        loads, 40, 12.0)
    jdec = jtrig.CrossoverTrigger(jg, p=1e-3, q=1e-4, floor=0.05).evaluate(
        loads, 40, 12.0)
    assert dec.__dict__ == jdec.__dict__


def test_pslb_matches():
    rng = np.random.default_rng(3)
    works = rng.uniform(1, 11, size=200)
    node = rng.integers(0, 8, size=200)
    powers = rng.integers(1, 10, size=8).astype(float)
    r, jr = pslb.pslb_assign(works, node, powers), jpslb.pslb_assign(
        works, node, powers)
    np.testing.assert_array_equal(r.dest, jr.dest)
    assert (r.moved_tasks, r.moved_units) == (jr.moved_tasks, jr.moved_units)
    np.testing.assert_array_equal(pslb.distribute_stream(works, powers),
                                  jpslb.distribute_stream(works, powers))


@pytest.mark.parametrize("process,kw", [("poisson", {"rate": 5.0}),
                                        ("bursty", {"rate_hi": 9.0}),
                                        ("diurnal", {"rate_mean": 3.0})])
def test_workloads_and_slotting_match(process, kw):
    wls = [workload.make_workload(process, horizon=50.0, seed=s, **kw)
           for s in range(3)]
    jwls = [jwl.make_workload(process, horizon=50.0, seed=s, **kw)
            for s in range(3)]
    for a, b in zip(wls, jwls):
        np.testing.assert_array_equal(a.t_arrive, b.t_arrive)
        np.testing.assert_array_equal(a.works, b.works)
    for a, b in zip(workload.batch_slots(wls, 0.5, 100),
                    jwl.batch_slots(jwls, 0.5, 100)):
        np.testing.assert_array_equal(a, b)


def test_metrics_and_policy_defaults_match():
    v = np.random.default_rng(4).exponential(size=101)
    for pct in (1.0, 50.0, 99.0, 100.0):
        assert metrics.nearest_rank(v, pct) == jmetrics.nearest_rank(v, pct)
    assert metrics.Metrics().summary().keys() == \
        jmetrics.Metrics().summary().keys()
    assert policies.PstsPolicy().__dict__ == jpol.PstsPolicy().__dict__
    loads = np.array([4.0, 0.0, 9.0, 1.0])
    powers = np.array([2.0, 1.0, 3.0, 1.0])
    assert policies.positional_arrival(loads, powers, 3.0) == \
        jpol.positional_arrival(loads, powers, 3.0)
    # the serving request scheduler registers "replica" on first use
    rep, jrep = policies.make_policy("replica"), jpol.make_policy("replica")
    assert type(rep).__name__ == type(jrep).__name__ == \
        "RequestSchedulerPolicy"
    assert rep.__dict__ == jrep.__dict__
