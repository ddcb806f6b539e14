"""Host slot loop of ``_simulate_batch_torch``: kernel launches in the
traced window over the slots it swept (copies not counted)."""

from __future__ import annotations


def read(trace):
    if not trace.kernels or not trace.slots:
        return None
    return len(trace.kernels) / trace.slots
