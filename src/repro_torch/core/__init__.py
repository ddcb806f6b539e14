"""PSTS core — the paper's contribution as a composable library.

Layers carried over from the JAX package so far:
  scan       — prefix-scan primitives (host numpy, torch tensors, and the
               cross-rank ladder along a DeviceMesh dimension)
  hypergrid  — hyper-grid embedding, virtual nodes, optimal dimension
  pslb       — 1-D positional scan load balancing
  psts       — recursive hyper-grid task scheduling
  cost_model — paper eqs. 8-12
  trigger    — crossover-point trigger (Tables 6-7)
  simulator  — paper-experiment cluster simulator (sec. 5)
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
    axis_exclusive_scan,
    axis_inclusive_scan,
    exclusive_scan,
    exclusive_scan_np,
    inclusive_scan,
    inclusive_scan_np,
    segment_positions,
)
from .simulator import (
    SimConfig,
    SimResult,
    crossover_table,
    simulate,
    sweep_nodes,
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
    "inclusive_scan_np", "segment_positions", "axis_exclusive_scan",
    "axis_inclusive_scan",
    "SimConfig", "SimResult", "crossover_table", "simulate", "sweep_nodes",
    "CrossoverTrigger", "TriggerDecision", "imbalance",
]
