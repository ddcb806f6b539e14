"""repro_torch.lab — experiments as data, on the GPU.

Declare an experiment once, exactly as for the JAX package's ``repro.lab``::

    from repro_torch import lab

    sc = lab.Scenario(
        cluster=lab.ClusterSpec(n_nodes=12500, power_seed=0),
        workload=lab.WorkloadSpec(process="poisson", horizon=200.0,
                                  work_mean=6.0, params={"rate": 6880.0}),
        policy=lab.PolicySpec("psts", params={"floor": 0.1}),
    )

then run it: ``lab.run(sc)`` replays it on the discrete-event engine (host
code, per-task state, any policy, faults), ``lab.run(sc, backend="legacy")``
on the static paper simulator. Or sweep it: ``lab.sweep(base=sc,
grid={"seed": range(128)})`` sends the uniform seed sweep to the batched
backend, one batched run on the CUDA device through the hand-written
kernels (``device="cpu"`` runs the plain PyTorch versions instead); small
or non-uniform sweeps and per-task policies run on the event engine.
Results carry the same canonical :class:`RunResult` schema and fingerprints
as ``repro.lab``. Trace replays (``TraceRef``, node ``attrs``), DAG
workloads, federations (``lab.Federation``, the ``federated`` backend) and
the scheduler service (the ``online`` backend) run as there. Scenario files
round-trip through JSON and the ``python -m repro_torch.lab`` CLI.
"""

from .api import BATCH_THRESHOLD, expand_grid, run, sweep
from .backends import (
    BACKENDS,
    BATCHED_POLICIES,
    Backend,
    BackendError,
    get_backend,
)
from .result import METRIC_SCHEMA, RunResult, make_metrics
from .specs import (
    ClusterSpec,
    FaultSpec,
    ObsSpec,
    PolicySpec,
    Scenario,
    TraceRef,
    WorkloadSpec,
    resolve_fault_schedule,
)

__all__ = [
    "BATCH_THRESHOLD", "expand_grid", "run", "sweep",
    "BACKENDS", "BATCHED_POLICIES", "Backend", "BackendError", "get_backend",
    "METRIC_SCHEMA", "RunResult", "make_metrics",
    "ClusterSpec", "FaultSpec", "ObsSpec", "PolicySpec", "Scenario",
    "TraceRef", "WorkloadSpec", "resolve_fault_schedule",
    "Federation", "LinkSpec", "TopologySpec",
]

# federation specs re-export lazily (PEP 562): repro_torch.federation itself
# imports repro_torch.lab.specs, so an eager import here would deadlock
# whichever package is imported first. By first attribute access both sides
# are done.
_FEDERATION_EXPORTS = ("Federation", "LinkSpec", "TopologySpec")


def __getattr__(name):
    if name in _FEDERATION_EXPORTS:
        from .. import federation
        return getattr(federation, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
