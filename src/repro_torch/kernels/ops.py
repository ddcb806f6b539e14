"""Kernel API: the tensor's own device picks the implementation.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel, or raises if it cannot (no fallback). Any
other device raises.
"""

from __future__ import annotations

import torch

from . import prefix_scan as _scan
from . import psts_dispatch as _dispatch
from . import ref

__all__ = ["prefix_scan", "dispatch_work_prefix", "launch_counts",
           "reset_launch_counts"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}; use cuda or cpu")


def prefix_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis."""
    if _on_cuda(x):
        return _scan.prefix_scan_cuda(x)
    return ref.prefix_scan_ref(x)


def dispatch_work_prefix(expert_idx: torch.Tensor, weights: torch.Tensor,
                         n_experts: int):
    """``(prefix (R, T), fill (R, E))``: per row, the weight of earlier
    same-destination tokens and the per-destination totals."""
    if _on_cuda(weights):
        return _dispatch.dispatch_work_prefix_cuda(expert_idx, weights,
                                                   n_experts)
    return ref.dispatch_work_prefix_ref(expert_idx, weights, n_experts)


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel in this process."""
    return {"prefix_scan": _scan.LAUNCHES,
            "dispatch_work_prefix": _dispatch.LAUNCHES}


def reset_launch_counts() -> None:
    _scan.LAUNCHES = 0
    _dispatch.LAUNCHES = 0
