"""``run`` / ``sweep``: the two entry points over every backend.

``run(scenario)`` executes one scenario on the discrete-event engine (or
the backend named) after eligibility validation. ``sweep(...)`` executes
many scenarios — given explicitly or expanded from a ``base`` x ``grid``
product — and auto-dispatches uniform seed sweeps of ``>= batch_threshold``
scenarios to the batched backend, where the whole sweep is ONE batched run
on the GPU; anything else runs scenario by scenario on the event engine.

Backend options pass through: ``dt`` and ``fifo_dispatch`` to the batched
backend, as in the JAX package. ``device`` is the port's own: the batched
backend runs on the CUDA device unless ``device="cpu"``. The events and
legacy backends are host code and take no options, so ``sweep`` hands
``device`` to the batched backend alone — one call can say where a sweep
runs if it is batched, whichever backend auto-dispatch picks. A sweep of
``Federation`` specs runs on the federated backend, whose vectorized
(link-free) path takes ``device`` the same way.
"""

from __future__ import annotations

import itertools
import warnings

from .backends import get_backend, uniform_but_for_seed
from .result import RunResult
from .specs import Scenario

__all__ = ["run", "sweep", "expand_grid", "BATCH_THRESHOLD"]

# seed sweeps at least this long go to the accelerator when eligible
BATCH_THRESHOLD = 8


def run(scenario: Scenario, backend: str = "events",
        **backend_options) -> RunResult:
    """Execute one scenario (or ``repro_torch.federation.Federation``) on one
    backend; raises ``BackendError`` with the reason when the spec is not
    expressible there."""
    return get_backend(backend).run(scenario, **backend_options)


def expand_grid(base: Scenario, grid: dict) -> list[Scenario]:
    """Cartesian product over dotted-path axes:
    ``expand_grid(sc, {"seed": range(64), "policy.name": ["jsq", "psts"]})``.
    """
    if not grid:
        return [base]
    paths = list(grid)
    out = []
    for combo in itertools.product(*(list(grid[p]) for p in paths)):
        out.append(base.updated(dict(zip(paths, combo))))
    return out


def sweep(scenarios: list[Scenario] | None = None, *,
          base: Scenario | None = None, grid: dict | None = None,
          backend: str = "auto", batch_threshold: int = BATCH_THRESHOLD,
          **backend_options) -> list[RunResult]:
    """Execute many scenarios; returns one RunResult per scenario, in order.

    Dispatch: ``backend="auto"`` sends uniform seed sweeps of
    ``>= batch_threshold`` batched-eligible scenarios to the batched backend
    in one call, and the event engine otherwise. Any explicit backend name
    forces that backend for every scenario. ``device`` reaches the batched
    backend only (the host backends have no device to pick), and the
    federated backend's vectorized path; a sweep of federations runs on the
    federated backend.
    """
    if scenarios is None:
        if base is None:
            raise ValueError("sweep needs scenarios or base (+ grid)")
        scenarios = expand_grid(base, grid or {})
    else:
        if base is not None or grid is not None:
            raise ValueError("give either scenarios or base+grid, not both")
        scenarios = list(scenarios)
    if not scenarios:
        return []

    batched = get_backend("batched")
    # federations (no .workload, their own backend) dispatch as a unit;
    # ``device`` reaches the federated backend's vectorized path
    if all(getattr(sc, "is_federation", False) for sc in scenarios):
        if backend == "auto":
            backend = "federated"
        if backend == "federated" and "dt" in backend_options:
            backend_options.pop("dt")  # slot width is batched-only
            warnings.warn("sweep dispatched to the 'federated' backend; "
                          "the batched-only 'dt' option is ignored",
                          stacklevel=2)
        chosen = get_backend(backend)
        for sc in scenarios:  # fail fast, before any federation has run
            chosen.check(sc)
        return [chosen.run(sc, **backend_options) for sc in scenarios]
    # a seed axis over one *unscaled* trace replays identical workloads —
    # flag it regardless of backend. A scaled trace (TraceRef(scale=N))
    # resamples per seed, so its seed axis is a real ensemble.
    def _replays_verbatim(sc) -> bool:
        wl = getattr(sc, "workload", None)
        if wl is None or not wl.is_trace:
            return False
        return wl.trace_path is not None or wl.trace.scale is None
    if (len(scenarios) > 1
            and all(_replays_verbatim(sc) for sc in scenarios)
            and len({sc.workload.trace_files() for sc in scenarios}) == 1
            and len({sc.seed for sc in scenarios}) > 1):
        warnings.warn("trace workloads ignore the seed axis — these "
                      "scenarios replay the identical trace (give the "
                      "TraceRef a scale= to resample per seed)",
                      stacklevel=2)
    uniform = (backend in ("auto", "batched")
               and uniform_but_for_seed(scenarios))
    if backend == "auto":
        # uniformity means eligibility only needs one representative:
        # scenarios differ in seed/name, which eligibility never reads
        batchable = (
            len(scenarios) >= batch_threshold
            and uniform
            and batched.eligible(scenarios[0]) is None)
        backend = "batched" if batchable else "events"
    if backend == "batched" and uniform:
        return batched.run_many(scenarios, **backend_options)
    if backend != "batched":
        backend_options.pop("device", None)
        if "dt" in backend_options:
            backend_options.pop("dt")  # slot width is batched-only
            warnings.warn(f"sweep dispatched to the {backend!r} backend; "
                          f"the batched-only 'dt' option is ignored",
                          stacklevel=2)
    chosen = get_backend(backend)
    for sc in scenarios:  # fail fast, before any scenario has run
        chosen.check(sc)
    return [chosen.run(sc, **backend_options) for sc in scenarios]
