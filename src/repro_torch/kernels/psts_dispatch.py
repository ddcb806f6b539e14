"""Hand-written CUDA kernel: the FIFO dispatch prefix in float64. Source:
``csrc/psts_dispatch.cu``, which replaces
``repro/kernels/psts_dispatch.py::dispatch_work_prefix_pallas``.

The Pallas kernel keeps a (block, 128) one-hot in VMEM and so rejects more
than 128 destinations, the TPU's lane width. The CUDA kernel keeps one
accumulator per destination and takes any count: the batched engine calls it
with one destination per cluster node (12,500 at full width).
``dispatch_positions_pallas`` (the unweighted variant) is not on this path
and is not ported yet.

``LAUNCHES`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["dispatch_work_prefix_cuda", "LAUNCHES"]

LAUNCHES = 0

_SIGNATURES = {
    "dispatch_work_prefix_f64": [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_void_p],
}


def dispatch_work_prefix_cuda(expert_idx: torch.Tensor, weights: torch.Tensor,
                              n_experts: int):
    """``expert_idx`` (R, T) int32 destination per token (outside ``[0,
    n_experts)`` = none), ``weights`` (R, T) float64, both contiguous on one
    CUDA device. Returns ``(prefix (R, T), fill (R, n_experts))``: the
    weight of earlier same-destination tokens in the row, and the
    per-destination totals."""
    global LAUNCHES
    if expert_idx.device.type != "cuda" or weights.device != expert_idx.device:
        raise ValueError(f"dispatch_work_prefix_cuda needs both tensors on one "
                         f"CUDA device, got {expert_idx.device} and "
                         f"{weights.device}")
    if expert_idx.dtype != torch.int32 or weights.dtype != torch.float64:
        raise TypeError(f"dispatch_work_prefix_cuda takes int32 destinations "
                        f"and float64 weights, got {expert_idx.dtype} and "
                        f"{weights.dtype}")
    if expert_idx.dim() != 2 or weights.shape != expert_idx.shape:
        raise ValueError(f"expert_idx and weights must share one (R, T) "
                         f"shape, got {tuple(expert_idx.shape)} and "
                         f"{tuple(weights.shape)}")
    if not (expert_idx.is_contiguous() and weights.is_contiguous()):
        raise ValueError("dispatch_work_prefix_cuda needs contiguous tensors")
    if n_experts < 1:
        raise ValueError(f"n_experts must be >= 1, got {n_experts}")
    r, t = expert_idx.shape
    prefix = torch.empty_like(weights)
    fill = torch.empty((r, n_experts), dtype=torch.float64,
                       device=weights.device)
    if r == 0:
        return prefix, fill
    lib = _build.load("psts_dispatch", _SIGNATURES)
    err = lib.dispatch_work_prefix_f64(
        expert_idx.data_ptr(), weights.data_ptr(), prefix.data_ptr(),
        fill.data_ptr(), r, t, n_experts, weights.device.index,
        _build.stream_of(weights))
    _build.check("psts_dispatch", "dispatch_work_prefix", err)
    LAUNCHES += 1
    return prefix, fill
