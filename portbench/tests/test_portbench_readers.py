"""The per-layer readers on a made-up trace: each reads what its layer
did, and nothing where the trace holds nothing for it."""

from __future__ import annotations

import pytest

from portbench.devtrace import DeviceTrace, idle_gaps, merge_busy, top_ops
from portbench.manifest import load_manifest, load_module
from portbench.yardstick import HBM_BYTES_PER_S, dispatch_bytes, scan_bytes


def _trace():
    # one sweep of 2 slots: a copy in, a scan, two dispatch calls, plain
    # ops, a copy out (times in us)
    kernels = [("sequential_scan_rows(double const*)", 110.0, 130.0),
               ("void work_prefix_stage<true>(int const*)", 140.0, 150.0),
               ("work_prefix_walk(int const*)", 150.0, 160.0),
               ("void at::native::elementwise_kernel<1>", 200.0, 230.0),
               ("sequential_scan_rows(double const*)", 240.0, 245.0),
               ("void at::native::reduce_kernel<2>", 250.0, 270.0),
               ("void work_prefix_stage<true>(int const*)", 300.0, 305.0),
               ("work_prefix_walk(int const*)", 305.0, 310.0)]
    copies = [("Memcpy HtoD (Pageable -> Device)", 0.0, 100.0),
              ("Memcpy DtoH (Device -> Pageable)", 320.0, 330.0)]
    calls = {"prefix_scan": [(4, 1000), (4, 10)],
             "dispatch_work_prefix": [(4, 1000, 2, False),
                                      (4, 1000, 10, True)]}
    return DeviceTrace(kernels=kernels, copies=copies, window_s=400e-6,
                       sweeps=1, slots=2, tasks=900, calls=calls)


def read(name, trace):
    return load_module("metrics", name).read(trace)


def test_readers():
    t = _trace()
    assert read("h2d_ms_per_sweep", t) == pytest.approx(0.1)
    assert read("launches_per_slot", t) == 4.0
    assert read("plain_ops_ms_per_slot", t) == pytest.approx(0.025)
    scan = (scan_bytes(4, 1000) + scan_bytes(4, 10)) / HBM_BYTES_PER_S
    assert read("prefix_scan_roofline", t) == pytest.approx(
        100 * scan / 25e-6)
    disp = (dispatch_bytes(4, 1000, 2, False, 0)
            + dispatch_bytes(4, 1000, 10, True, 0) + 2 * 900 * 8)
    assert read("dispatch_work_prefix_roofline", t) == pytest.approx(
        100 * disp / HBM_BYTES_PER_S / 30e-6)
    busy = 100 + 20 + 20 + 30 + 5 + 20 + 10 + 10      # us, no overlap
    assert t.busy_s == pytest.approx(busy * 1e-6)
    assert read("device_idle_pct", t) == pytest.approx(
        100 * (1 - busy / 400))


def test_readers_find_nothing_in_an_empty_trace():
    empty = DeviceTrace(kernels=[], copies=[], window_s=1.0, sweeps=1,
                        slots=200, tasks=10)
    for entry in load_manifest()["per_layer"]:
        assert read(entry["name"], empty) is None


def test_busy_union_and_breakdown():
    assert merge_busy([("a", 0, 10), ("b", 5, 12), ("c", 20, 21)]) == [
        (0, 12), (20, 21)]
    t = _trace()
    gaps = idle_gaps(t)
    assert gaps[0] == ["host: the slot loop issues launches",
                       pytest.approx(40e-6)]
    assert all(len(g) == 2 for g in gaps) and len(gaps) <= 10
    ops = top_ops(t)
    assert ops[0][0].startswith("Memcpy HtoD") and len(ops) <= 10
