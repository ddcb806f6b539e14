"""Device layer: the share of the traced window in which neither a kernel
nor a copy ran on the card, in %."""

from __future__ import annotations


def read(trace):
    if not (trace.kernels or trace.copies) or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
