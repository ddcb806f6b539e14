"""The port's batched engine held against the JAX package's: the same
numpy inputs through ``repro.runtime.simulate_batch`` (Pallas kernels in
interpret mode), the port's ``simulate_batch`` on the CPU (plain PyTorch
versions of the kernels) and the numpy ``simulate_scalar`` oracle, per seed
at rtol 1e-6 — the tolerance of tests/test_runtime_vector.py."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import dataclasses

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.runtime import vector_backend as jvb  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    VectorConfig,
    batch_slots,
    make_workload,
    simulate_batch,
    simulate_scalar,
    sweep_seeds,
    to_tensors,
)

POWERS = np.array([3.0, 1.0, 7.0, 2.0, 5.0, 9.0, 4.0, 6.0,
                   2.0, 8.0, 1.0, 5.0, 3.0, 6.0, 4.0, 7.0])

FIELDS = ["mean_response", "p99_response", "makespan", "trigger_fires",
          "moved_units", "completed"]
PROBES = ["probe_queue", "probe_imbalance", "probe_crossover", "probe_fires"]


def _batch(process, n_seeds, cfg, **kw):
    wls = [make_workload(process, horizon=cfg.n_slots * cfg.dt, seed=s, **kw)
           for s in range(n_seeds)]
    return batch_slots(wls, cfg.dt, cfg.n_slots)


def _jax_cfg(cfg):
    return jvb.VectorConfig(**dataclasses.asdict(cfg))


def _hold(cfg, slot, works, powers, scale=None, seeds=None):
    """Port vs the JAX engine (every seed) and vs simulate_scalar (the
    given seeds); returns the port's metrics."""
    got = simulate_batch(slot, works, powers, cfg, power_scale=scale,
                         device="cpu")
    want = jvb.simulate_batch(slot, works, powers, _jax_cfg(cfg),
                              power_scale=scale)
    for k in FIELDS + (PROBES if cfg.probe else []):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    for i in (range(works.shape[0]) if seeds is None else seeds):
        sm = simulate_scalar(slot[i], works[i], powers, cfg,
                             power_scale=scale)
        for k in FIELDS:
            np.testing.assert_allclose(getattr(got, k)[i], sm[k], rtol=1e-6,
                                       err_msg=f"seed {i}, {k}")
    return got


def test_poisson_matches_jax_engine_and_scalar():
    cfg = VectorConfig(n_nodes=16, n_slots=120, dt=1.0, rebalance=True,
                       floor=0.1)
    slot, works, _ = _batch("poisson", 16, cfg, rate=6.0)
    got = _hold(cfg, slot, works, POWERS)
    assert (got.trigger_fires > 0).any()


def test_bursty_with_outage_matches():
    cfg = VectorConfig(n_nodes=16, n_slots=80, dt=1.0, rebalance=True,
                       floor=0.1)
    slot, works, _ = _batch("bursty", 16, cfg, rate_hi=8.0)
    scale = np.ones((cfg.n_slots, cfg.n_nodes))
    scale[20:50, 3] = 0.0   # node 3 down, then rejoining
    scale[35:60, 9] = 0.0
    _hold(cfg, slot, works, POWERS, scale=scale, seeds=range(0, 16, 3))


def test_diurnal_no_rebalance_matches():
    cfg = VectorConfig(n_nodes=8, n_slots=60, dt=0.5, rebalance=False)
    slot, works, _ = _batch("diurnal", 8, cfg, rate_mean=4.0)
    got = _hold(cfg, slot, works, POWERS[:8])
    assert (got.trigger_fires == 0).all()
    assert (got.moved_units == 0).all()


def test_fifo_dispatch_matches_and_refines_responses():
    cfg = VectorConfig(n_nodes=8, n_slots=60, dt=1.0, fifo_dispatch=True)
    slot, works, _ = _batch("poisson", 12, cfg, rate=6.0)
    got = _hold(cfg, slot, works, POWERS[:8])
    plain = simulate_batch(slot, works, POWERS[:8],
                           VectorConfig(n_nodes=8, n_slots=60, dt=1.0),
                           device="cpu")
    assert (got.mean_response >= plain.mean_response - 1e-12).all()
    assert (got.mean_response > plain.mean_response).any()
    np.testing.assert_allclose(got.makespan, plain.makespan)
    np.testing.assert_allclose(got.moved_units, plain.moved_units)


@pytest.mark.parametrize("rebalance", [True, False])
def test_probe_series_match(rebalance):
    cfg = VectorConfig(n_nodes=16, n_slots=50, dt=1.0, rebalance=rebalance,
                       floor=0.1, probe=True)
    slot, works, _ = _batch("bursty", 4, cfg, rate_hi=10.0)
    scale = np.ones((cfg.n_slots, cfg.n_nodes))
    scale[10:30, 5] = 0.0
    got = _hold(cfg, slot, works, POWERS, scale=scale)
    assert got.probe_queue.shape == (4, 50, 16)
    for i in range(4):
        sm = simulate_scalar(slot[i], works[i], POWERS, cfg,
                             power_scale=scale)
        for k in PROBES:
            np.testing.assert_allclose(getattr(got, k)[i], sm[k],
                                       rtol=1e-6, atol=1e-9)


def test_trigger_floor_hysteresis():
    base = dict(n_nodes=16, n_slots=100, dt=1.0, rebalance=True,
                p=1e-6, q=1e-7, t_task=1e-7)
    slot, works, _ = _batch("bursty", 4, VectorConfig(floor=0.0, **base),
                            rate_hi=8.0)
    fires = {floor: simulate_batch(slot, works, POWERS,
                                   VectorConfig(floor=floor, **base),
                                   device="cpu").trigger_fires.sum()
             for floor in [0.0, 0.5, 1e9]}
    assert fires[0.0] > 0
    assert fires[1e9] == 0
    assert fires[0.0] >= fires[0.5] >= fires[1e9]


def test_sweep_seeds_matches_jax():
    cfg = VectorConfig(n_nodes=16, n_slots=60, dt=1.0)
    got = sweep_seeds("poisson", range(10), POWERS, cfg, rate=4.0,
                      device="cpu")
    want = jvb.sweep_seeds("poisson", range(10), POWERS, _jax_cfg(cfg),
                           rate=4.0)
    assert got.mean_response.shape == (10,)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6)
    assert len(np.unique(got.mean_response)) == 10


def test_rebalance_rescues_stranded_work():
    base = dict(n_nodes=16, n_slots=150, dt=1.0, floor=0.1)
    wls = [make_workload("bursty", horizon=60.0, seed=s, rate_lo=2.0,
                         rate_hi=25.0, sojourn_lo=10.0, sojourn_hi=8.0,
                         work_mean=6.0)
           for s in range(6)]
    slot, works, _ = batch_slots(wls, 1.0, 150)
    scale = np.ones((150, 16))
    scale[30:, 5] = 0.0
    on = simulate_batch(slot, works, POWERS,
                        VectorConfig(rebalance=True, **base),
                        power_scale=scale, device="cpu")
    off = simulate_batch(slot, works, POWERS,
                         VectorConfig(rebalance=False, **base),
                         power_scale=scale, device="cpu")
    assert (off.makespan >= 149.0).mean() >= 0.5, off.makespan
    assert on.makespan.mean() < off.makespan.mean() - 10.0
    assert (on.trigger_fires >= 1).all()


def test_runs_are_bit_identical():
    cfg = VectorConfig(n_nodes=16, n_slots=40, dt=1.0, fifo_dispatch=True,
                       probe=True)
    slot, works, _ = _batch("poisson", 5, cfg, rate=9.0)
    a = simulate_batch(slot, works, POWERS, cfg, device="cpu")
    b = simulate_batch(slot, works, POWERS, cfg, device="cpu")
    for k in FIELDS + PROBES:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_empty_workload():
    cfg = VectorConfig(n_nodes=4, n_slots=5)
    slot = np.zeros((2, 0), np.int32)
    works = np.zeros((2, 0))
    got = simulate_batch(slot, works, POWERS[:4], cfg, device="cpu")
    assert (got.completed == 0).all()
    assert np.isnan(got.mean_response).all() and np.isnan(got.p99_response).all()
    assert (got.makespan == 0).all()


def test_to_tensors_dtypes_shapes_and_config_copy():
    cfg = VectorConfig(n_nodes=4, n_slots=3, fifo_dispatch=True)
    assert dataclasses.asdict(_jax_cfg(cfg)) == dataclasses.asdict(cfg)
    slot = np.array([[0, 1, 3]])
    works = np.array([[1.0, 2.0, 0.0]], np.float32)
    s, w, p, sc = to_tensors(slot, works, POWERS[:4], None, device="cpu")
    assert s.dtype == torch.int32 and w.dtype == torch.float64
    assert p.shape == (1, 4) and p.dtype == torch.float64
    assert sc is None
    *_, sc = to_tensors(slot, works, POWERS[:4], np.ones((3, 4)),
                        device="cpu")
    assert sc.dtype == torch.float64 and sc.shape == (3, 4)


def test_no_gpu_and_no_device_raises(monkeypatch):
    """The entry points never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VectorConfig(n_nodes=4, n_slots=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_batch(np.zeros((1, 1), np.int32), np.ones((1, 1)),
                       POWERS[:4], cfg)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 127, 128, 129, 300, 1000,
                               8191, 8192, 8193, 12500, 20000])
def test_np_sum_is_numpys_order(n):
    """``_np_sum`` gives each row numpy's own float64 sum, bit for bit (the
    buffer chunks, the pairwise halving, the 8 accumulators of a block)."""
    from repro_torch.runtime.vector_backend import _np_sum
    x = np.random.default_rng(n).uniform(0.0, 9.0, size=(3, n)) * 1e3
    got = _np_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, [np.sum(np.ascontiguousarray(row)) for row in x])


def _scaled_trace_batch(cfg, seeds, scale):
    from repro_torch.traces import load_trace
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "benchmarks" / "data"
            / "google_excerpt_10k.csv.gz")
    wls = [load_trace(str(path), format="google",
                      params={"eviction_mode": "end"}, scale=scale,
                      seed=s, horizon=cfg.n_slots * cfg.dt)
           for s in seeds]
    return batch_slots(wls, cfg.dt, cfg.n_slots)


@pytest.mark.parametrize("case", ["poisson", "bursty-outage",
                                  "trace-fifo", "trace"])
def test_engine_state_is_the_oracles_bit_for_bit(case):
    """The queues, the trigger's imbalance, crossover and fires, and the
    moved volume equal simulate_scalar's bit for bit, slot by slot, as the
    card's kernels must reproduce them: a task within an ulp of an
    interval edge would otherwise take the neighbouring node. A bursty,
    rate-scaled trace fires the trigger on most slots."""
    powers = POWERS
    scale = None
    if case.startswith("trace"):
        cfg = VectorConfig(n_nodes=16, n_slots=150, fifo_dispatch=case ==
                           "trace-fifo", probe=True, floor=0.1)
        slot, works, _ = _scaled_trace_batch(cfg, (0, 1), 0.3)
    else:
        cfg = VectorConfig(n_nodes=16, n_slots=120, fifo_dispatch=True,
                           probe=True, floor=0.05)
        process, kw = (("poisson", dict(rate=12.0, work_mean=6.0))
                       if case == "poisson" else
                       ("bursty", dict(rate_lo=2.0, rate_hi=40.0,
                                       sojourn_lo=10.0, sojourn_hi=4.0,
                                       work_mean=6.0)))
        slot, works, _ = _batch(process, 3, cfg, **kw)
        if case == "bursty-outage":
            scale = np.ones((cfg.n_slots, 16))
            scale[20:60, 3] = 0.0
            scale[40:, 7] = 0.5
    got = simulate_batch(slot, works, powers, cfg, power_scale=scale,
                         device="cpu")
    fires = 0
    for i in range(works.shape[0]):
        sm = simulate_scalar(slot[i], works[i], powers, cfg,
                             power_scale=scale)
        for k in PROBES + ["moved_units", "trigger_fires", "makespan",
                           "completed"]:
            np.testing.assert_array_equal(getattr(got, k)[i], sm[k],
                                          err_msg=f"seed {i}, {k}")
        for k in ("mean_response", "p99_response"):
            np.testing.assert_allclose(getattr(got, k)[i], sm[k],
                                       rtol=1e-12, err_msg=f"seed {i}, {k}")
        fires += sm["trigger_fires"]
    assert fires > 0
