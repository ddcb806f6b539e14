"""Hand-written CUDA kernels of PSTS dispatch. Source:
``csrc/psts_dispatch.cu``, one shared library with two kernels:

- ``dispatch_work_prefix_cuda`` — the FIFO dispatch prefix in float64, which
  replaces ``repro/kernels/psts_dispatch.py::dispatch_work_prefix_pallas``
  (the batched engine's path);
- ``dispatch_positions_cuda`` — the MoE expert-dispatch positions in int32,
  which replaces ``repro/kernels/psts_dispatch.py::dispatch_positions_pallas``
  (the LM's path: ``sched/moe_dispatch.py::_positions_scan``).

The Pallas kernels keep a (block, 128) one-hot in VMEM and so reject more
than 128 destinations, the TPU's lane width, and the positions kernel takes
one token row. The CUDA kernels keep one counter per destination and take
any count (the batched engine calls the prefix with one destination per
cluster node, 12,500 at full width), and the positions kernel takes a batch
of rows (the MoE layer's token groups).

``LAUNCHES`` and ``POSITION_LAUNCHES`` count each kernel's launches in this
process.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["dispatch_work_prefix_cuda", "dispatch_positions_cuda",
           "LAUNCHES", "POSITION_LAUNCHES"]

LAUNCHES = 0
POSITION_LAUNCHES = 0

_SIGNATURES = {
    "dispatch_work_prefix_f64": [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_void_p],
    "dispatch_positions_i32": [ctypes.c_void_p, ctypes.c_void_p,
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


def dispatch_positions_cuda(expert_idx: torch.Tensor, base: torch.Tensor,
                            n_experts: int):
    """``expert_idx`` (R, T) int32 expert per token (outside ``[0,
    n_experts)`` = none), ``base`` (R, n_experts) int32 prior fills, both
    contiguous on one CUDA device. Returns ``(pos (R, T), fill (R,
    n_experts))`` int32: each token's exclusive position within its expert
    counted from ``base`` (0 for a token without one), and the fills
    including ``base``. Exact."""
    global POSITION_LAUNCHES
    if expert_idx.device.type != "cuda" or base.device != expert_idx.device:
        raise ValueError(f"dispatch_positions_cuda needs both tensors on one "
                         f"CUDA device, got {expert_idx.device} and "
                         f"{base.device}")
    if expert_idx.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError(f"dispatch_positions_cuda takes int32 experts and "
                        f"base, got {expert_idx.dtype} and {base.dtype}")
    if n_experts < 1:
        raise ValueError(f"n_experts must be >= 1, got {n_experts}")
    if expert_idx.dim() != 2 or base.shape != (expert_idx.shape[0],
                                               n_experts):
        raise ValueError(f"expert_idx must be (R, T) and base (R, "
                         f"{n_experts}), got {tuple(expert_idx.shape)} and "
                         f"{tuple(base.shape)}")
    if not (expert_idx.is_contiguous() and base.is_contiguous()):
        raise ValueError("dispatch_positions_cuda needs contiguous tensors")
    r, t = expert_idx.shape
    pos = torch.empty_like(expert_idx)
    fill = torch.empty_like(base)
    if r == 0:
        return pos, fill
    lib = _build.load("psts_dispatch", _SIGNATURES)
    err = lib.dispatch_positions_i32(
        expert_idx.data_ptr(), base.data_ptr(), pos.data_ptr(),
        fill.data_ptr(), r, t, n_experts, expert_idx.device.index,
        _build.stream_of(expert_idx))
    _build.check("psts_dispatch", "dispatch_positions", err)
    POSITION_LAUNCHES += 1
    return pos, fill
