"""Kernel layer, ``csrc/prefix_scan.cu`` (``ops.prefix_scan``): the sum of
the calls' byte bounds over the sum of their kernels' device time, in % of
the HBM roofline. Each call's bytes come from its shapes
(``yardstick.scan_bytes``)."""

from __future__ import annotations

from portbench.yardstick import HBM_BYTES_PER_S, is_port_kernel, scan_bytes


def read(trace):
    calls = trace.calls.get("prefix_scan")
    busy_us = sum(end - start for name, start, end in trace.kernels
                  if is_port_kernel(name, "prefix_scan"))
    if not calls or busy_us <= 0:
        return None
    bound_s = sum(scan_bytes(*shape) for shape in calls) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (busy_us / 1e6)
