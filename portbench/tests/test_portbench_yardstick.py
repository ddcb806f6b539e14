"""The frozen byte counts against the bounds in PERF.md's table of kernels
(the H100 data sheet's 3.35 TB/s)."""

from __future__ import annotations

import pytest

from portbench.yardstick import (HBM_BYTES_PER_S, dispatch_bytes,
                                 is_port_kernel, scan_bytes)

B, M, N, T = 128, 1378880, 12500, 200


def ms(n_bytes):
    return n_bytes / HBM_BYTES_PER_S * 1e3


def test_scan_bound():
    # row 1: 0.8430 ms at (128, 1378880), 16 B an element
    assert ms(scan_bytes(B, M)) == pytest.approx(0.8430, abs=5e-5)


def test_dispatch_bounds():
    # row 2, the slot wave at E = n (one slot's 6,880 x 128 tasks routed):
    # 0.6382 ms; row 2', the per-slot totals at E = T, every task: 1.0529
    assert ms(dispatch_bytes(B, M, N, False, 6880 * B)) == pytest.approx(
        0.6382, abs=5e-4)
    assert ms(dispatch_bytes(B, M, T, False, 1376000 * B)) == pytest.approx(
        1.0529, abs=2e-3)


def test_dispatch_init_reads_the_cells():
    assert (dispatch_bytes(2, 10, 7, True, 3)
            - dispatch_bytes(2, 10, 7, False, 3)) == 2 * 7 * 8
    assert (dispatch_bytes(2, 10, 7, False, 3)
            == 2 * 10 * 12 + 3 * 8 + 2 * 7 * 8)


def test_port_kernel_names():
    assert is_port_kernel("sequential_scan_rows(double const*, double*, "
                          "long)", "prefix_scan")
    assert is_port_kernel("void work_prefix_stage<true>(int const*)",
                          "dispatch_work_prefix")
    assert is_port_kernel("work_prefix_walk(int const*)")
    assert not is_port_kernel("void at::native::vectorized_elementwise_"
                              "kernel<4>", None)
    assert not is_port_kernel("work_prefix_walk", "prefix_scan")
