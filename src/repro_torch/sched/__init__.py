"""Schedulers built on the PSTS core: MoE token -> expert dispatch and the
serving request -> replica scheduler."""

from .moe_dispatch import (
    DispatchResult,
    dispatch,
    dispatch_grouped,
    router_aux_loss,
)
from .request_sched import ReplicaScheduler, Request, RequestSchedulerPolicy

__all__ = ["DispatchResult", "dispatch", "dispatch_grouped",
           "router_aux_loss", "Request", "ReplicaScheduler",
           "RequestSchedulerPolicy"]
