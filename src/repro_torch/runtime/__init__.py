"""Runtime: workloads, metrics, policies, the event engine and the batched
PSTS engine.

The event engine (``runtime.py`` over ``events.py``) drives one cluster
through time on the host — staggered arrivals, nonpreemptive FIFO service,
node failures/joins/resizes, in-flight migrations and periodic
crossover-trigger evaluation — under any registered policy. The batched
engine (``vector_backend``) runs B scenario seeds over T slots on the GPU
through the hand-written scan and dispatch kernels.
"""

from .events import Event, EventKind, EventQueue
from .metrics import Metrics, nearest_rank
from .policies import POLICIES, Policy, make_policy, positional_arrival
from .runtime import ClusterRuntime, ClusterView, Task, run_policy
from .vector_backend import (
    BatchMetrics,
    VectorConfig,
    simulate_batch,
    simulate_scalar,
    sweep_seeds,
    to_tensors,
)
from .workload import (
    ARRIVAL_PROCESSES,
    Workload,
    batch_slots,
    load_trace_csv,
    make_workload,
)

__all__ = [
    "Event", "EventKind", "EventQueue",
    "Metrics", "nearest_rank",
    "POLICIES", "Policy", "make_policy", "positional_arrival",
    "ClusterRuntime", "ClusterView", "Task", "run_policy",
    "BatchMetrics", "VectorConfig", "simulate_batch", "simulate_scalar",
    "sweep_seeds", "to_tensors",
    "ARRIVAL_PROCESSES", "Workload", "batch_slots", "load_trace_csv",
    "make_workload",
]
