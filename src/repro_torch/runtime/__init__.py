"""Runtime: workloads, metrics, policies and the batched PSTS engine.

The batched engine (``vector_backend``) runs B scenario seeds over T slots on
the GPU through the hand-written scan and dispatch kernels. The JAX
package's event engine (``runtime.py``, ``events.py``) comes with a later
slice of the port.
"""

from .metrics import Metrics, nearest_rank
from .policies import POLICIES, Policy, make_policy, positional_arrival
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
    "Metrics", "nearest_rank",
    "POLICIES", "Policy", "make_policy", "positional_arrival",
    "BatchMetrics", "VectorConfig", "simulate_batch", "simulate_scalar",
    "sweep_seeds", "to_tensors",
    "ARRIVAL_PROCESSES", "Workload", "batch_slots", "load_trace_csv",
    "make_workload",
]
