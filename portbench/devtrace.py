"""A device-only profiler trace of the window, reduced to what the per-layer
readers need.

Only the card is traced (``ProfilerActivity.CUDA``): the kernels' times are
the same with the host's ops traced too, and reading those costs about three
times as long (``chip_smoke.device_time_table``). The raw events are read
from the profiler's result without building its per-op tree, and only their
names and times are kept: no Chrome trace is written.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["DeviceTrace", "device_events", "merge_busy", "idle_gaps",
           "top_ops"]

_COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class DeviceTrace:
    """The device's events in the traced window, in microseconds from the
    trace's start, with the counts of the work the window did.

    ``kernels`` and ``copies`` are ``(name, start_us, end_us)``; ``calls``
    maps a port kernel op to the argument shapes of each of its calls in the
    window; ``window_s`` is the window's length on the host's clock."""

    kernels: list
    copies: list
    window_s: float
    sweeps: int
    slots: int
    tasks: int
    calls: dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        """Seconds in which a kernel or a copy ran on the device."""
        return sum(end - start
                   for start, end in merge_busy(self.kernels + self.copies)
                   ) / 1e6


def device_events(prof) -> tuple[list, list]:
    """``(kernels, copies)`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        start = e.start_ns() / 1e3
        events.append((e.name(), start, start + e.duration_ns() / 1e3))
    events.sort(key=lambda ev: ev[1])
    kernels = [ev for ev in events if not ev[0].startswith(_COPY_PREFIXES)]
    copies = [ev for ev in events if ev[0].startswith(_COPY_PREFIXES)]
    return kernels, copies


def merge_busy(events) -> list:
    """The union of the events' intervals, as sorted ``(start, end)``."""
    merged = []
    for _, start, end in sorted(events, key=lambda ev: ev[1]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(iv) for iv in merged]


def idle_gaps(trace: DeviceTrace, top: int = 10) -> list:
    """The ``top`` longest gaps between device work, each named by what the
    host was doing: staging a sweep's inputs (the gap ends at a copy to the
    card), taking a sweep's results and calling again (it starts after a
    copy from the card), or issuing the slot loop's launches."""
    events = sorted(trace.kernels + trace.copies, key=lambda ev: ev[1])
    gaps = []
    end_name, end_at = None, None
    for name, start, end in events:
        if end_at is not None and start > end_at:
            if name.startswith("Memcpy HtoD"):
                what = "host: to_tensors stages the sweep's inputs"
            elif end_name.startswith("Memcpy DtoH"):
                what = "host: results to numpy, the next sweep called"
            else:
                what = "host: the slot loop issues launches"
            gaps.append([what, (start - end_at) / 1e6])
        if end_at is None or end > end_at:
            end_name, end_at = name, end
    gaps.sort(key=lambda g: -g[1])
    return gaps[:top]


def top_ops(trace: DeviceTrace, top: int = 10) -> list:
    """The ``top`` device operations by total seconds, ``[name, s]``."""
    totals: dict[str, float] = {}
    for name, start, end in trace.kernels + trace.copies:
        totals[name] = totals.get(name, 0.0) + (end - start) / 1e6
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:200], seconds] for name, seconds in ranked]
