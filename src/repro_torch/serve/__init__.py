"""Serving layer: scheduler-as-a-service plus the token-serving engine.

Two services live here:

* :class:`SchedulerService` — the cluster scheduler as an incremental
  online engine behind the session API: tasks stream in from
  :class:`TaskSource` feeds, the engine advances in bounded micro-steps,
  and every placement/migration/trigger decision is emitted live as a
  :class:`Decision` record. Host code (numpy); imports no kernels.
* :class:`Engine` — the continuous-batching token-serving engine over the
  LM's prefill/decode on the GPU. It loads lazily: importing
  ``repro_torch.serve`` for the scheduler service never touches kernel
  code.
"""

from .scheduler import Decision, DecisionLog, SchedulerService
from .session import Session
from .sources import (
    IterableSource,
    JsonlSource,
    TaskSource,
    TaskSubmit,
    WorkloadSource,
)

_ENGINE_NAMES = {"Engine", "GenRequest"}


def __getattr__(name):
    if name in _ENGINE_NAMES:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Decision", "DecisionLog", "SchedulerService",
    "Session",
    "TaskSubmit", "TaskSource", "IterableSource", "JsonlSource",
    "WorkloadSource",
    "Engine", "GenRequest",
]
