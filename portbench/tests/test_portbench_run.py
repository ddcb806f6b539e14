"""A whole run of each cell on the CPU at a tiny size, past the look for a
card: sound, it comes out correct; with the float32 control in the
program's place, or with the timed path broken underneath, it does not."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.manifest import load_module
from portbench.run import result_line, run_cell

CELLS = ("clusterdata-12.5k.poisson", "alibaba-4k.bursty")
SEED = 2**31 + 12345


def _run(cell, tiny_bench, seed=SEED):
    manifest, bench_dir = tiny_bench
    return run_cell(cell, seed=seed, seconds=0.0, trace=False, device="cpu",
                    started=time.perf_counter(), manifest=manifest,
                    bench_dir=bench_dir)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_bench):
    cell_, outcome = _run(cell, tiny_bench)
    assert outcome.correct, outcome.checks
    assert outcome.attempted >= 2 and outcome.failed == 0
    value, limit = outcome.checks["max_rel_gap"]
    assert value <= limit
    line = result_line(cell_, outcome, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"sweep_tasks_per_s", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_trigger_and_queues_are_exercised(cell, tiny_bench):
    """The tiny cells reach the trigger and the FIFO path that the check is
    meant to hold, so the faults below have something to break."""
    _, bench_dir = tiny_bench
    from portbench import gen
    from portbench.manifest import load_cell
    c = load_cell(cell, tiny_bench[0], bench_dir)
    ref = load_module("references", c.config["reference"])
    powers = gen.node_powers(c.config)
    (slot, works, _), = gen.draw_sweeps(c.traffic, c.config, powers, SEED,
                                        1, "cpu")
    out = ref.simulate(slot[0], works[0], powers, c.config)
    assert out["completed"] > 0 and out["mean_response"] > 0
    assert out["trigger_fires"] > 0 and out["moved_units"] > 0


def _float32_control(cell_name, tiny_bench):
    """The reference in float32, put in the program's place."""
    from portbench.manifest import load_cell
    c = load_cell(cell_name, tiny_bench[0], tiny_bench[1])
    ref = load_module("references", c.config["reference"])

    def control(slot, works, powers, cfg, power_scale=None, *, device=None):
        rows = [ref.simulate(slot[b], works[b], powers, c.config,
                             dtype=np.float32) for b in range(slot.shape[0])]
        return SimpleNamespace(**{k: np.array([r[k] for r in rows])
                                  for k in ref.FIELDS})
    return control


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails(cell, tiny_bench, monkeypatch):
    from repro_torch.runtime import vector_backend
    monkeypatch.setattr(vector_backend, "simulate_batch",
                        _float32_control(cell, tiny_bench))
    _, outcome = _run(cell, tiny_bench)
    value, limit = outcome.checks["max_rel_gap"]
    assert not outcome.correct and value > 3 * limit


def _state_unchanged(monkeypatch):
    """The slot's dispatch wave hands the queues back as it found them."""
    from repro_torch.kernels import ops
    dispatch = ops.dispatch_work_prefix

    def broken(expert_idx, weights, n_experts, init=None):
        ahead, fill = dispatch(expert_idx, weights, n_experts, init)
        return ahead, (fill if init is None else init.clone())
    monkeypatch.setattr(ops, "dispatch_work_prefix", broken)


def _half_left_out(monkeypatch):
    """The engine sees the first half of each scenario's tasks only, its
    mean taken over those."""
    from repro_torch.runtime import vector_backend
    engine = vector_backend.simulate_batch

    def broken(slot, works, powers, cfg, power_scale=None, *, device=None):
        slot, works = slot.copy(), works.copy()
        real = (slot < cfg.n_slots).sum(axis=1)
        for b, m in enumerate(real):
            slot[b, m // 2:] = cfg.n_slots
            works[b, m // 2:] = 0.0
        return engine(slot, works, powers, cfg, power_scale, device=device)
    monkeypatch.setattr(vector_backend, "simulate_batch", broken)


def _answer_altered(monkeypatch):
    """Each scenario's mean response is produced one task-slot late: one
    task's response counted a slot longer."""
    from repro_torch.runtime import vector_backend
    engine = vector_backend.simulate_batch

    def broken(slot, works, powers, cfg, power_scale=None, *, device=None):
        out = engine(slot, works, powers, cfg, power_scale, device=device)
        return SimpleNamespace(**{
            **out.__dict__,
            "mean_response": out.mean_response + cfg.dt / out.completed})
    monkeypatch.setattr(vector_backend, "simulate_batch", broken)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state-unchanged", "half-left-out",
                              "answer-altered"])
def test_broken_timed_path_is_not_correct(cell, fault, tiny_bench,
                                          monkeypatch):
    fault(monkeypatch)
    _, outcome = _run(cell, tiny_bench)
    assert not outcome.correct
    assert outcome.failed >= 1
