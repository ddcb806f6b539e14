"""The batched engine's own spans and counters (``simulate_batch(...,
tracer=)``): the same answers with and without a tracer, the span tree of
each call, its counters, and its Chrome export. The tests marked ``cuda``
hold the CUDA events' device times and the shared clock on the card; they
skip without one (``python -m pytest -q -m cuda
tests/test_torch_vector_trace.py`` runs them there)."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import itertools
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.obs import PID_ENGINE, Tracer
from repro_torch.runtime import (
    VectorConfig,
    batch_slots,
    make_workload,
    simulate_batch,
    sweep_seeds,
)
from repro_torch.runtime import vector_backend

FIELDS = ["mean_response", "p99_response", "makespan", "trigger_fires",
          "moved_units", "completed", "probe_queue", "probe_imbalance",
          "probe_crossover", "probe_fires"]
PHASES = ("owner_search", "dispatch", "trigger_service")
POWERS = np.array([3.0, 1.0, 7.0, 2.0, 5.0, 9.0, 4.0, 6.0,
                   2.0, 8.0, 1.0, 5.0, 3.0, 6.0, 4.0, 7.0])


def _sweep(n_seeds=4, n_slots=24, rate=6.0):
    wls = [make_workload("bursty", horizon=float(n_slots), seed=s,
                         rate_hi=3 * rate)
           for s in range(n_seeds)]
    return batch_slots(wls, 1.0, n_slots)


def _engine_events(tracer, ph):
    return [e for e in tracer.to_chrome_trace()["traceEvents"]
            if e["ph"] == ph and e["pid"] == PID_ENGINE]


def _calls(tracer):
    """Each call's spans, ``{name: [event, ...]}``, by trace id."""
    calls: dict = {}
    for e in _engine_events(tracer, "X"):
        calls.setdefault(e["args"]["trace_id"], {}).setdefault(
            e["name"], []).append(e)
    return list(calls.values())


def _assert_same(a, b):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if x is None:
            assert y is None, k
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("fifo,probe,rebalance",
                         list(itertools.product((False, True), repeat=3)))
def test_metrics_are_the_same_bits_with_a_tracer(fifo, probe, rebalance):
    cfg = VectorConfig(n_nodes=16, n_slots=24, fifo_dispatch=fifo,
                       probe=probe, rebalance=rebalance)
    slot, works, _ = _sweep()
    scale = np.ones((24, 16))
    scale[6:12, 2] = 0.0
    tracer = Tracer()
    got = simulate_batch(slot, works, POWERS, cfg, power_scale=scale,
                         device="cpu", tracer=tracer)
    want = simulate_batch(slot, works, POWERS, cfg, power_scale=scale,
                          device="cpu")
    _assert_same(got, want)
    assert len(_calls(tracer)) == 1


def test_span_tree_of_each_call():
    cfg = VectorConfig(n_nodes=16, n_slots=24, fifo_dispatch=True)
    slot, works, _ = _sweep()
    tracer = Tracer()
    for _ in range(2):
        simulate_batch(slot, works, POWERS, cfg, device="cpu", tracer=tracer)
    calls = _calls(tracer)
    assert len(calls) == 2
    assert calls[0]["simulate_batch"][0]["args"]["trace_id"] != \
        calls[1]["simulate_batch"][0]["args"]["trace_id"]
    for spans in calls:
        (root,) = spans["simulate_batch"]
        assert root["args"]["span_id"] == root["args"]["trace_id"]
        assert "parent_id" not in root["args"]
        assert {k: root["args"][k] for k in ("B", "M", "T", "n")} == {
            "B": 4, "M": works.shape[1], "T": 24, "n": 16}
        (loop,) = spans["slot_loop"]
        for name in ("to_tensors", "tables", "slot_loop", "finish",
                     "results"):
            assert len(spans[name]) == 1
            assert spans[name][0]["args"]["parent_id"] == \
                root["args"]["span_id"]
        for name in PHASES:
            assert [e["args"]["slot"] for e in spans[name]] == list(range(24))
            assert {e["args"]["parent_id"] for e in spans[name]} == {
                loop["args"]["span_id"]}
        ids = [e["args"]["span_id"] for v in spans.values() for e in v]
        assert len(set(ids)) == len(ids) == 6 + 3 * 24

        def inside(child, parent):
            # to the export's rounding: ts is Unix-epoch microseconds
            return (parent["ts"] - 1.0 <= child["ts"] and child["ts"]
                    + child["dur"] <= parent["ts"] + parent["dur"] + 1.0)
        for name, events in spans.items():
            parent = (loop if name in PHASES else
                      root if name != "simulate_batch" else None)
            for e in events:
                assert parent is None or inside(e, parent), name
                assert "device_ms" not in e["args"]    # CPU: no events
        # the leaves follow one another without gaps or overlaps
        leaves = sorted((e for name, v in spans.items() for e in v
                         if name not in ("simulate_batch", "slot_loop")),
                        key=lambda e: e["ts"])
        for a, b in zip(leaves, leaves[1:]):
            assert a["ts"] + a["dur"] == pytest.approx(b["ts"], abs=1.0)


def test_counters_of_a_call():
    cfg = VectorConfig(n_nodes=16, n_slots=24)
    slot, works, _ = _sweep()
    scale = np.ones((24, 16))
    tracer = Tracer()
    out = simulate_batch(slot, works, POWERS, cfg, power_scale=scale,
                         device="cpu", tracer=tracer)
    counters = {e["name"]: e["args"][e["name"]]
                for e in _engine_events(tracer, "C")}
    assert counters["h2d_bytes"] == (
        np.ascontiguousarray(slot, dtype=np.int32).nbytes
        + np.ascontiguousarray(works, dtype=np.float64).nbytes
        + POWERS.nbytes + scale.nbytes)
    assert counters["elements_swept"] == 24 * works.shape[0] * works.shape[1]
    assert counters["tasks"] == out.completed.sum() == (slot < 24).sum()
    (root,) = _calls(tracer)[0]["simulate_batch"]
    (h2d,) = _calls(tracer)[0]["to_tensors"]
    assert h2d["args"]["h2d_bytes"] == counters["h2d_bytes"]
    for e in _engine_events(tracer, "C"):        # at the call's end
        assert e["ts"] == pytest.approx(root["ts"] + root["dur"], abs=1.0)


def test_np_sum_plans_are_built_once_a_width():
    # 23 nodes: a width no other test of this module sums over
    cfg = VectorConfig(n_nodes=23, n_slots=8)
    slot, works, _ = _sweep(n_slots=8)
    powers = np.arange(1.0, 24.0)
    fresh = (23, torch.device("cpu")) not in vector_backend._NP_SUM_PLANS
    builds = []
    for _ in range(2):
        tracer = Tracer()
        simulate_batch(slot, works, powers, cfg, device="cpu", tracer=tracer)
        builds += [e["args"]["np_sum_plan_builds"]
                   for e in _engine_events(tracer, "C")
                   if e["name"] == "np_sum_plan_builds"]
    assert builds[1] == 0
    assert builds[0] == (1 if fresh else 0)


def test_no_tracer_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a call without a tracer made a recorder")
    monkeypatch.setattr(vector_backend, "_CallSpans", refuse)
    monkeypatch.setattr(Tracer, "wall_clock", refuse)
    cfg = VectorConfig(n_nodes=16, n_slots=12, probe=True)
    slot, works, _ = _sweep(n_slots=12)
    simulate_batch(slot, works, POWERS, cfg, device="cpu")


def test_sweep_seeds_passes_the_tracer_on():
    cfg = VectorConfig(n_nodes=16, n_slots=12)
    tracer = Tracer()
    got = sweep_seeds("poisson", range(3), POWERS, cfg, device="cpu",
                      tracer=tracer, rate=6.0)
    want = sweep_seeds("poisson", range(3), POWERS, cfg, device="cpu",
                       rate=6.0)
    _assert_same(got, want)
    (spans,) = _calls(tracer)
    assert len(spans["dispatch"]) == 12


def test_chrome_export_names_the_engine_lane_and_is_strict_json():
    cfg = VectorConfig(n_nodes=16, n_slots=6)
    slot, works, _ = _sweep(n_slots=6)
    tracer = Tracer()
    simulate_batch(slot, works, POWERS, cfg, device="cpu", tracer=tracer)
    doc = json.loads(json.dumps(tracer.to_chrome_trace(), allow_nan=False))
    lanes = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert lanes[PID_ENGINE] == "engine (wall clock)"
    assert doc["otherData"]["n_events"] == 6 + 3 * 6 + 4
    # a trace without engine events keeps the three host lanes alone
    assert PID_ENGINE not in {e["pid"] for e in Tracer().to_chrome_trace()
                              ["traceEvents"]}


def test_wall_clock_is_unix_time():
    import time
    tracer = Tracer()
    before = time.time()
    t = tracer.wall_clock()
    assert before - 1e-3 <= t <= time.time() + 1e-3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events and the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_times_on_the_card(cuda):
    cfg = VectorConfig(n_nodes=256, n_slots=40, fifo_dispatch=True,
                       probe=True)
    wls = [make_workload("poisson", horizon=40.0, seed=s, rate=400.0)
           for s in range(16)]
    slot, works, _ = batch_slots(wls, 1.0, 40)
    powers = np.random.default_rng(0).integers(1, 11, size=256) * 1.0
    want = simulate_batch(slot, works, powers, cfg, device=cuda)
    tracer = Tracer()
    got = simulate_batch(slot, works, powers, cfg, device=cuda,
                         tracer=tracer)
    _assert_same(got, want)
    (spans,) = _calls(tracer)
    ms = {name: sum(e["args"]["device_ms"] for e in v)
          for name, v in spans.items()}
    assert all(e["args"]["device_ms"] >= 0.0
               for v in spans.values() for e in v)
    phases = sum(ms[name] for name in PHASES)
    assert phases == pytest.approx(ms["slot_loop"], rel=0.03)
    leaves = sum(v for name, v in ms.items()
                 if name not in ("simulate_batch", "slot_loop"))
    assert leaves == pytest.approx(ms["simulate_batch"], rel=0.03)


@pytest.mark.cuda
def test_spans_share_the_profilers_clock(cuda):
    """Spans around synchronize -> one scan launch -> synchronize, five in
    one profiled session: each holds its kernel as the profiler stamps it,
    the kernel's end lies within 100 us before the span's end, and the
    span's start within 100 us before the kernel's start in the quickest
    launch. A clock off by more than 100 us fails one of the bounds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.rand(128, 100_000, dtype=torch.float64, device=cuda)
    ops.prefix_scan(x)                    # built and loaded before the span
    torch.cuda.synchronize()
    tracer = Tracer()
    spans = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = tracer.wall_clock()
            ops.prefix_scan(x)
            torch.cuda.synchronize()
            spans.append((t0 * 1e6, tracer.wall_clock() * 1e6))
    kernels = sorted(
        (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
    assert len(kernels) == len(spans)
    for (t0, t1), (start, end) in zip(spans, kernels):
        assert t0 <= start and end <= t1
        assert t1 - end <= 100.0
    assert min(start - t0 for (t0, _), (start, _) in zip(spans, kernels)) \
        <= 100.0
