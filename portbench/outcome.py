"""What a runner hands back to ``run.py`` after one run of a cell."""

from __future__ import annotations

from dataclasses import dataclass

from .devtrace import DeviceTrace

__all__ = ["Outcome"]


@dataclass
class Outcome:
    """``values`` maps each end-to-end metric the runner measured to its
    value; ``checks`` maps each number compared with the reference to
    ``(value, limit)``; ``device`` holds ``platform``, ``kind``, ``count``
    and ``memory_peak_bytes``; ``trace`` is the traced window's (``--trace
    1``) or None."""

    correct: bool
    attempted: int
    failed: int
    values: dict
    checks: dict
    device: dict
    trace: DeviceTrace | None = None
