"""Runner of the batched PSTS sweep engine: closed-loop seed sweeps through
``repro_torch.runtime.vector_backend.simulate_batch``.

One request is one sweep of B scenario seeds of the cell's deployment; one
tuner sends the next sweep when the last one returns.

* Set-up draws two distinct sweeps from the seed on the card (``gen.py``)
  into host arrays, the engine's inputs, and warms the engine once on the
  wider of the two, cut to one slot: the same (B, M) tensors and kernels,
  every task arriving in it (see ``_warm``).
* The window alternates the two sweeps, whole sweeps, until ``seconds``
  have passed (and at least one of each ran).
* After the window, the plain reference recomputes a sample of the
  window's scenarios, drawn from the seed, with the most loaded scenario of
  each sweep in it, and every scenario's completed count is held against the
  tasks drawn for it.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from portbench import gen
from portbench.devtrace import DeviceTrace, device_events
from portbench.manifest import load_module
from portbench.outcome import Outcome

__all__ = ["LIMITS", "SAMPLES", "vector_config", "sample_scenarios",
           "rel_gap", "check_window", "run"]

# the widest relative gap of a compared metric, set between the program's
# readings (at most 4.1e-16 over 12 seeds a cell) and the float32
# control's (at least 1.5e-2); PERF.md gives the readings
LIMITS = {"max_rel_gap": 1e-8}
# random scenarios recomputed by the reference a run, besides each sweep's
# most loaded scenario
SAMPLES = 14
_POLICY_KEYS = ("n_slots", "dt", "rebalance", "floor", "p", "q", "t_task",
                "packets_per_step", "packets_per_unit", "fifo_dispatch")


def vector_config(config: dict):
    from repro_torch.runtime.vector_backend import VectorConfig
    return VectorConfig(n_nodes=config["n_nodes"],
                        **{k: config[k] for k in _POLICY_KEYS})


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want|; 0 where both are equal (NaN alike), inf where
    ``want`` is 0 and ``got`` is not, or ``got`` is not finite."""
    if got == want or (math.isnan(got) and math.isnan(want)):
        return 0.0
    if not math.isfinite(got) or want == 0.0:
        return math.inf
    return abs(got - want) / abs(want)


def sample_scenarios(seed: int, calls: list, sweeps: list,
                     count: int = SAMPLES) -> list:
    """``(call, row)`` pairs to recompute: the most loaded row of each
    sweep in its first call, and ``count`` more drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    picks = []
    for s, (_, _, tasks) in enumerate(sweeps):
        first = next(i for i, which in enumerate(calls) if which == s)
        picks.append((first, int(np.argmax(tasks))))
    rows = sweeps[0][0].shape[0]
    for flat in rng.choice(len(calls) * rows, size=min(count,
                           len(calls) * rows), replace=False):
        picks.append((int(flat) // rows, int(flat) % rows))
    return list(dict.fromkeys(picks))


def check_window(config: dict, powers: np.ndarray, sweeps: list,
                 calls: list, answers: list, picks: list,
                 dtype=np.float64) -> tuple[float, int]:
    """``(max_rel_gap, failed calls)``: the six metrics of each picked
    scenario against the reference run in ``dtype``, and every scenario's
    completed count against its tasks drawn, over the window's answers."""
    ref = load_module("references", config["reference"])
    limit = LIMITS["max_rel_gap"]
    worst, bad = 0.0, set()
    for i, (which, out) in enumerate(zip(calls, answers)):
        tasks = sweeps[which][2]
        gaps = [rel_gap(float(c), float(t))
                for c, t in zip(out.completed, tasks)]
        worst = max(worst, *gaps)
        if max(gaps) > limit:
            bad.add(i)
    for i, row in picks:
        slot, works, _ = sweeps[calls[i]]
        want = ref.simulate(slot[row], works[row], powers, config,
                            dtype=dtype)
        got = answers[i]
        gap = max(rel_gap(float(getattr(got, k)[row]), want[k])
                  for k in ref.FIELDS)
        worst = max(worst, gap)
        if gap > limit:
            bad.add(i)
    return worst, len(bad)


@contextmanager
def _recording_calls(calls: dict):
    """Record the shapes of every call into the port's two kernel ops (a
    span from the benchmark's side around each call into the kernel
    layer); the yardstick's byte counts read them."""
    from repro_torch.kernels import ops
    scan, dispatch = ops.prefix_scan, ops.dispatch_work_prefix
    calls.update(prefix_scan=[], dispatch_work_prefix=[])

    def scan_recorded(x):
        calls["prefix_scan"].append((x.numel() // max(x.shape[-1], 1),
                                     x.shape[-1]))
        return scan(x)

    def dispatch_recorded(expert_idx, weights, n_experts, init=None):
        calls["dispatch_work_prefix"].append(
            (expert_idx.shape[0], expert_idx.shape[1], n_experts,
             init is not None))
        return dispatch(expert_idx, weights, n_experts, init)

    ops.prefix_scan, ops.dispatch_work_prefix = (scan_recorded,
                                                 dispatch_recorded)
    try:
        yield
    finally:
        ops.prefix_scan, ops.dispatch_work_prefix = scan, dispatch


def _window(engine, sweeps, powers, cfg, seconds, device_arg, sync):
    """Whole sweeps, alternating, until ``seconds`` have passed and each
    sweep ran once. Returns ``(calls, answers, ends)``: each sweep's return
    in seconds from the window's start."""
    calls, answers, ends = [], [], []
    sync()
    start = time.perf_counter()
    while True:
        which = len(calls) % len(sweeps)
        slot, works, _ = sweeps[which]
        answers.append(engine(slot, works, powers, cfg, device=device_arg))
        calls.append(which)
        ends.append(time.perf_counter() - start)
        if ends[-1] >= seconds and len(calls) >= len(sweeps):
            return calls, answers, ends


def _warm(engine, sweep, powers, cfg, device_arg):
    """One engine call on the sweep's own (B, M) arrays, with every task in
    a single slot: every kernel of the slot loop, the plans of ``_np_sum``
    and the allocator's blocks at the window's sizes, in one slot's time
    instead of a sweep's. Only the (B, T) tables differ, and they are
    small."""
    slot, works, _ = sweep
    one = np.where(slot < cfg.n_slots, 0, 1).astype(np.int32)
    engine(one, works, powers, dataclasses.replace(cfg, n_slots=1),
           device=device_arg)


def _devices_used() -> int:
    """The CUDA devices on which the run allocated memory."""
    return sum(1 for d in range(torch.cuda.device_count())
               if torch.cuda.max_memory_allocated(d) > 0)


def _log(*parts):
    print("portbench:", *parts, file=sys.stderr, flush=True)


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        started: float) -> Outcome:
    """One run of a sweep cell on ``device`` ("cuda", or "cpu" in the
    tests); ``started`` is the process's start on ``time.perf_counter``."""
    from repro_torch.runtime import vector_backend

    config, traffic = cell.config, cell.traffic
    on_cuda = device == "cuda"
    device_arg = None if on_cuda else device     # the entry's own default
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    powers = gen.node_powers(config)
    cfg = vector_config(config)
    t_imported = time.perf_counter()
    sweeps = gen.draw_sweeps(traffic, config, powers, seed, 2, device)
    t_drawn = time.perf_counter()
    _warm(vector_backend.simulate_batch,
          max(sweeps, key=lambda s: s[0].shape[1]), powers, cfg, device_arg)
    sync()
    setup_end = time.perf_counter()
    setup_s = setup_end - started
    _log(f"set-up {setup_s:.3f}s: start to the program imported "
         f"{t_imported - started:.3f}s, two sweeps drawn "
         f"{t_drawn - t_imported:.3f}s (widths "
         f"{[s[0].shape[1] for s in sweeps]}, tasks "
         f"{[int(s[2].sum()) for s in sweeps]}), warm call "
         f"{setup_end - t_drawn:.3f}s")

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    calls_seen: dict = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile
        with _recording_calls(calls_seen), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls, answers, ends = _window(
                vector_backend.simulate_batch, sweeps, powers, cfg, seconds,
                device_arg, sync)
            sync()
    else:
        calls, answers, ends = _window(
            vector_backend.simulate_batch, sweeps, powers, cfg, seconds,
            device_arg, sync)
    elapsed = ends[-1]
    _log(f"window {elapsed:.3f}s, sweeps {calls}, each "
         f"{[round(b - a, 4) for a, b in zip([0.0] + ends, ends)]}s")
    peak = torch.cuda.max_memory_allocated() if on_cuda else None
    tasks = sum(int(sweeps[which][2].sum()) for which in calls)

    device_trace = None
    if trace:
        kernels, copies = device_events(prof)
        device_trace = DeviceTrace(
            kernels=kernels, copies=copies, window_s=elapsed,
            sweeps=len(calls), slots=len(calls) * config["n_slots"],
            tasks=tasks, calls=calls_seen)

    picks = sample_scenarios(seed, calls, sweeps)
    t_check = time.perf_counter()
    worst, failed = check_window(config, powers, sweeps, calls, answers,
                                 picks)
    _log(f"reference on {len(picks)} scenarios "
         f"{time.perf_counter() - t_check:.3f}s")
    limit = LIMITS["max_rel_gap"]
    return Outcome(
        correct=failed == 0 and worst <= limit,
        attempted=len(calls), failed=failed,
        values={"sweep_tasks_per_s": tasks / elapsed,
                "peak_device_gib": None if peak is None else peak / 2**30,
                "setup_s": setup_s},
        checks={"max_rel_gap": (worst, limit)},
        device={"platform": "gpu" if on_cuda else device,
                "kind": (torch.cuda.get_device_name(0) if on_cuda
                         else device),
                "count": _devices_used() if on_cuda else 1,
                "memory_peak_bytes": peak},
        trace=device_trace)
