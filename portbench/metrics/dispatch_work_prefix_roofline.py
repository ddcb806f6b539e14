"""Kernel layer, ``csrc/psts_dispatch.cu``'s ``work_prefix_stage`` +
``work_prefix_walk`` (``ops.dispatch_work_prefix``): the sum of the calls'
byte bounds over the sum of their kernels' device time, in % of the HBM
roofline. Each call's bytes come from its shapes
(``yardstick.dispatch_bytes``); the weights read are those of the routed
tokens, which the shapes do not give: every real task is routed twice a
sweep, once by the per-slot totals and once in its slot's wave, so twice
the window's tasks (8 B each, under 1% of the bytes)."""

from __future__ import annotations

from portbench.yardstick import (HBM_BYTES_PER_S, dispatch_bytes,
                                 is_port_kernel)


def read(trace):
    calls = trace.calls.get("dispatch_work_prefix")
    busy_us = sum(end - start for name, start, end in trace.kernels
                  if is_port_kernel(name, "dispatch_work_prefix"))
    if not calls or busy_us <= 0:
        return None
    n_bytes = sum(dispatch_bytes(rows, tokens, experts, init, 0)
                  for rows, tokens, experts, init in calls)
    n_bytes += dispatch_bytes(0, 0, 0, False, 2 * trace.tasks)
    return 100.0 * n_bytes / HBM_BYTES_PER_S / (busy_us / 1e6)
