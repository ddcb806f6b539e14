"""Hand-written CUDA kernels of PSTS dispatch. Source:
``csrc/psts_dispatch.cu``, one shared library:

- ``dispatch_work_prefix_cuda`` — the FIFO dispatch prefix in float64, which
  replaces ``repro/kernels/psts_dispatch.py::dispatch_work_prefix_pallas``
  (the batched engine's path). One call is two launches, a bandwidth pass
  that stages each chunk's valid tokens and an ordered walk over them; it
  counts as one launch;
- ``dispatch_positions_levels_cuda`` — the MoE expert-dispatch positions in
  int32 over all k priority levels of a layer in one launch, the clamp to
  the capacity between levels inside the kernel; it replaces k calls of
  ``repro/kernels/psts_dispatch.py::dispatch_positions_pallas`` (the LM's
  path: ``sched/moe_dispatch.py::_positions_scan``);
- ``dispatch_positions_cuda`` — one level with a prior fill ``base`` and no
  clamp: the same kernel with k = 1.

The Pallas kernels keep a (block, 128) one-hot in VMEM and so reject more
than 128 destinations, the TPU's lane width, and the positions kernel takes
one token row. The CUDA kernels keep one counter per destination and take
any count (the batched engine calls the prefix with one destination per
cluster node, 12,500 at full width), and the positions kernel takes a batch
of rows (the MoE layer's token groups).

``LAUNCHES`` counts the FIFO prefix's calls and ``POSITION_LAUNCHES`` the
positions kernel's launches (both position ops) in this process.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["dispatch_work_prefix_cuda", "dispatch_positions_levels_cuda",
           "dispatch_positions_cuda", "LAUNCHES", "POSITION_LAUNCHES"]

LAUNCHES = 0
POSITION_LAUNCHES = 0

_SIGNATURES = {
    "dispatch_work_prefix_f64": [ctypes.c_void_p] * 8 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p],
    "dispatch_positions_levels_i32": [ctypes.c_void_p] * 5 + [
        ctypes.c_int64] * 5 + [ctypes.c_int, ctypes.c_void_p],
}
_INT32_MAX = 2 ** 31 - 1
_CHUNK = 16_384   # kChunk in csrc/psts_dispatch.cu: a staging region's tokens


def dispatch_work_prefix_cuda(expert_idx: torch.Tensor, weights: torch.Tensor,
                              n_experts: int, init: torch.Tensor | None = None):
    """``expert_idx`` (R, T) int32 destination per token (outside ``[0,
    n_experts)`` = none), ``weights`` (R, T) float64, ``init`` (R,
    n_experts) float64 starting sums or None (zeros), all contiguous on one
    CUDA device. Returns ``(prefix (R, T), fill (R, n_experts))``: ``init``
    plus the weight of earlier same-destination tokens in the row, and
    ``init`` plus the per-destination totals, each destination's sum taken
    left to right (``ref.dispatch_work_prefix_ref``'s bits)."""
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
    if not 1 <= n_experts <= _INT32_MAX:
        raise ValueError(f"n_experts must lie in [1, 2**31 - 1], got "
                         f"{n_experts}")
    r, t = expert_idx.shape
    if init is not None and (
            init.device != weights.device or init.dtype != torch.float64
            or init.shape != (r, n_experts) or not init.is_contiguous()):
        raise ValueError(f"init must be a contiguous float64 ({r}, "
                         f"{n_experts}) tensor on {weights.device}, got "
                         f"{init.dtype} {tuple(init.shape)} on {init.device}")
    if t > _INT32_MAX:
        raise ValueError(f"a row holds at most 2**31 - 1 tokens, got {t}")
    dev = weights.device
    prefix = torch.empty_like(weights)
    fill = torch.empty((r, n_experts), dtype=torch.float64, device=dev)
    if r == 0:
        return prefix, fill
    # staging: one region of _CHUNK tokens per chunk of each row
    chunks = -(-t // _CHUNK)
    stage_je = torch.empty((r, chunks, _CHUNK, 2), dtype=torch.int32,
                           device=dev)
    stage_w = torch.empty((r, chunks, _CHUNK), dtype=torch.float64,
                          device=dev)
    meta = torch.empty((r, chunks, 4), dtype=torch.int32, device=dev)
    lib = _build.load("psts_dispatch", _SIGNATURES)
    err = lib.dispatch_work_prefix_f64(
        expert_idx.data_ptr(), weights.data_ptr(), prefix.data_ptr(),
        fill.data_ptr(), stage_je.data_ptr(), stage_w.data_ptr(),
        meta.data_ptr(), None if init is None else init.data_ptr(), r, t,
        n_experts, dev.index,
        _build.stream_of(weights))
    _build.check("psts_dispatch", "dispatch_work_prefix", err)
    LAUNCHES += 1
    return prefix, fill


def _check_positions(name, topk, base, n_experts, dims):
    if topk.device.type != "cuda" or (base is not None
                                      and base.device != topk.device):
        raise ValueError(f"{name} needs its tensors on one CUDA device, got "
                         f"{topk.device}"
                         + ("" if base is None else f" and {base.device}"))
    if topk.dtype != torch.int32 or (base is not None
                                     and base.dtype != torch.int32):
        raise TypeError(f"{name} takes int32 experts and base, got "
                        f"{topk.dtype}"
                        + ("" if base is None else f" and {base.dtype}"))
    if not 1 <= n_experts <= _INT32_MAX:
        raise ValueError(f"n_experts must lie in [1, 2**31 - 1], got "
                         f"{n_experts}")
    if topk.dim() != dims or (base is not None and base.shape != (
            topk.shape[0], n_experts)):
        raise ValueError(f"{name}: experts must have {dims} dimensions and "
                         f"base be (R, {n_experts}), got "
                         f"{tuple(topk.shape)}"
                         + ("" if base is None else
                            f" and {tuple(base.shape)}"))
    if not (topk.is_contiguous() and (base is None or base.is_contiguous())):
        raise ValueError(f"{name} needs contiguous tensors")


def _launch_positions(topk, base, n_experts, capacity, keep):
    """pos and fill of the levels kernel: topk (R, T, k) contiguous."""
    global POSITION_LAUNCHES
    r, t, k = topk.shape
    if t * k > _INT32_MAX:
        raise ValueError(f"a row holds at most 2**31 - 1 (token, level) "
                         f"cells, got {t} x {k}")
    pos = torch.empty_like(topk)
    fill = torch.empty((r, n_experts), dtype=torch.int32, device=topk.device)
    kept = (torch.empty(topk.shape, dtype=torch.bool, device=topk.device)
            if keep else None)
    if r == 0:
        return pos, kept, fill
    lib = _build.load("psts_dispatch", _SIGNATURES)
    err = lib.dispatch_positions_levels_i32(
        topk.data_ptr(), None if base is None else base.data_ptr(),
        pos.data_ptr(), None if kept is None else kept.data_ptr(),
        fill.data_ptr(), r, t, k, n_experts, capacity, topk.device.index,
        _build.stream_of(topk))
    _build.check("psts_dispatch", "dispatch_positions", err)
    POSITION_LAUNCHES += 1
    return pos, kept, fill


def dispatch_positions_levels_cuda(topk_idx: torch.Tensor, n_experts: int,
                                   capacity: int):
    """``topk_idx`` (R, T, k) int32 expert per token and priority level
    (outside ``[0, n_experts)`` = none), contiguous on a CUDA device; one
    launch. Returns ``(slot_idx (R, T, k) int32, keep (R, T, k) bool,
    filled (R, n_experts) int32)``: level s counts from ``min(fill of
    level s - 1, capacity)`` (0 at level 0), a token keeps its slot iff it
    lies below ``capacity``, and ``filled`` is the last level's fill clamped
    to ``capacity``. Exact."""
    _check_positions("dispatch_positions_levels_cuda", topk_idx, None,
                     n_experts, 3)
    if not 0 <= capacity <= _INT32_MAX:
        raise ValueError(f"capacity must lie in [0, 2**31 - 1], got "
                         f"{capacity}")
    return _launch_positions(topk_idx, None, n_experts, capacity, True)


def dispatch_positions_cuda(expert_idx: torch.Tensor, base: torch.Tensor,
                            n_experts: int):
    """``expert_idx`` (R, T) int32 expert per token (outside ``[0,
    n_experts)`` = none), ``base`` (R, n_experts) int32 prior fills, both
    contiguous on one CUDA device. Returns ``(pos (R, T), fill (R,
    n_experts))`` int32: each token's exclusive position within its expert
    counted from ``base`` (0 for a token without one), and the fills
    including ``base``. Exact."""
    _check_positions("dispatch_positions_cuda", expert_idx, base,
                     n_experts, 2)
    pos, _, fill = _launch_positions(expert_idx[:, :, None], base, n_experts,
                                     _INT32_MAX, False)
    return pos[:, :, 0], fill
