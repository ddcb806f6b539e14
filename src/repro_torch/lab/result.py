"""Canonical run results: one schema for every backend.

Each backend reports the same metric keys (``METRIC_SCHEMA`` — exactly the
shared :meth:`repro_torch.runtime.Metrics.summary` schema). A backend that cannot
measure a quantity reports ``None`` for it, never a different key set, so
result tables from different backends align column-for-column. Quantities
that only exist for one backend (the legacy simulator's crossover point,
say) go in ``extras``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

__all__ = ["METRIC_SCHEMA", "RunResult", "make_metrics"]

# exactly Metrics.summary()'s keys, in its order
METRIC_SCHEMA = (
    "arrived",
    "completed",
    "makespan",
    "mean_response",
    "p99_response",
    "mean_wait",
    "migrations",
    "moved_packets",
    "moved_units",
    "trigger_evals",
    "trigger_fires",
    "restarts",
    "failures",
    "joins",
    "resizes",
    "evictions",
    "admitted_work",
    "completed_work",
    "wasted_work",
    "locality_hits",
    "locality_misses",
    "locality_hit_ratio",
    "dag_bytes_moved",
    "cp_lower_bound",
    "cp_stretch",
)


def make_metrics(**values) -> dict:
    """A full-schema metrics dict: unknown keys rejected, missing keys
    ``None`` (the backend does not measure them)."""
    unknown = set(values) - set(METRIC_SCHEMA)
    if unknown:
        raise ValueError(f"metrics outside the canonical schema: "
                         f"{sorted(unknown)}")
    return {k: values.get(k) for k in METRIC_SCHEMA}


@dataclass(frozen=True)
class RunResult:
    """One scenario executed by one backend.

    ``fingerprint`` ties the result to the Scenario that produced it;
    ``backend``/``backend_options`` are the execution provenance (which
    surface, with which discretization); ``metrics`` is the canonical
    schema; ``extras`` holds backend-specific derived quantities.
    """

    fingerprint: str
    backend: str
    backend_options: dict
    metrics: dict
    extras: dict = field(default_factory=dict)
    scenario_name: str = ""

    def __post_init__(self):
        if tuple(self.metrics) != METRIC_SCHEMA:
            object.__setattr__(self, "metrics", make_metrics(**self.metrics))

    def to_dict(self) -> dict:
        """JSON-safe form: non-finite floats become ``None`` (a NaN metric
        means 'nothing measured' — e.g. mean response with zero
        completions — and bare ``NaN`` literals are not valid JSON)."""
        def clean(v):
            if isinstance(v, float) and not math.isfinite(v):
                return None
            return v
        return {
            "fingerprint": self.fingerprint,
            "backend": self.backend,
            "backend_options": dict(self.backend_options),
            "metrics": {k: clean(v) for k, v in self.metrics.items()},
            "extras": {k: clean(v) for k, v in self.extras.items()},
            "scenario_name": self.scenario_name,
        }

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          allow_nan=False)

    @classmethod
    def from_dict(cls, d: dict) -> "RunResult":
        return cls(**d)

    def __getitem__(self, key: str):
        return self.metrics[key]
