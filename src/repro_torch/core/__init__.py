"""PSTS core — the paper's contribution as a composable library.

Layers carried over from the JAX package so far:
  scan       — prefix-scan primitives (host numpy, torch tensors)
  hypergrid  — hyper-grid embedding, virtual nodes, optimal dimension
  pslb       — 1-D positional scan load balancing
  psts       — recursive hyper-grid task scheduling
  cost_model — paper eqs. 8-12
  trigger    — crossover-point trigger (Tables 6-7)

``simulator`` (the section-5 simulator) comes with a later slice of the
port.
"""

from .cost_model import (
    crossover_imbalance,
    execution_time,
    optimal_cost,
    scan_steps,
    step_cost,
)
from .hypergrid import HyperGrid, embed, factorize, optimal_dim
from .pslb import (
    PslbResult,
    apportion,
    distribute_stream,
    owner_of_fraction,
    pslb_assign,
)
from .psts import ScheduleResult, psts_schedule, sender_receiver
from .scan import (
    exclusive_scan,
    exclusive_scan_np,
    inclusive_scan,
    inclusive_scan_np,
    segment_positions,
)
from .trigger import CrossoverTrigger, TriggerDecision, imbalance

__all__ = [
    "crossover_imbalance", "execution_time", "optimal_cost", "scan_steps",
    "step_cost",
    "HyperGrid", "embed", "factorize", "optimal_dim",
    "PslbResult", "apportion", "distribute_stream", "owner_of_fraction",
    "pslb_assign",
    "ScheduleResult", "psts_schedule", "sender_receiver",
    "exclusive_scan", "exclusive_scan_np", "inclusive_scan",
    "inclusive_scan_np", "segment_positions",
    "CrossoverTrigger", "TriggerDecision", "imbalance",
]
