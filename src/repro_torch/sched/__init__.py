"""PSTS scheduling integrations:

  moe_dispatch  — token -> expert positional-scan dispatch (on the GPU)
  data_balance  — sequence -> data-shard balancing (host, per step)
  request_sched — request -> replica continuous-batching scheduler; its
                  decision logic is also registered as the ``"replica"``
                  policy of the event-driven cluster runtime
                  (``repro_torch.runtime``)
  straggler     — adaptive processing-power estimation (EWMA step times)
"""

from .data_balance import BalanceResult, balance_sequences, sequence_work
from .moe_dispatch import (
    DispatchResult,
    dispatch,
    dispatch_grouped,
    router_aux_loss,
)
from .request_sched import ReplicaScheduler, Request, RequestSchedulerPolicy
from .straggler import StragglerMonitor

__all__ = ["DispatchResult", "dispatch", "dispatch_grouped",
           "router_aux_loss", "Request", "ReplicaScheduler",
           "RequestSchedulerPolicy", "BalanceResult", "balance_sequences",
           "sequence_work", "StragglerMonitor"]
