"""Kernel API: the tensor's own device picks the implementation.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel, or raises if it cannot (no fallback). A
meta tensor (the dry run: shapes, no values) takes the plain version for
its shapes alone. A DTensor is refused: it reports its mesh's device type
and would reach a kernel whole, where a kernel takes this rank's local
tensors. Any other device raises.

``flash_attention`` (index form) and ``mamba_scan`` carry a gradient: on the
CPU autograd runs through the plain versions, on the card through
``torch.autograd.Function``s whose backward is a hand-written kernel
(``flash_attention_bwd``, ``mamba_scan_bwd``), used only when a gradient is
asked for; otherwise the forward kernel runs alone, as the serving path has
it.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import prefix_scan as _scan
from . import psts_dispatch as _dispatch
from . import ref

__all__ = ["prefix_scan", "dispatch_work_prefix", "dispatch_positions",
           "dispatch_positions_levels", "flash_attention", "mamba_scan",
           "launch_counts", "reset_launch_counts"]


def _on_cuda(t: torch.Tensor) -> bool:
    if isinstance(t, DTensor):
        raise TypeError("the kernels take local tensors, not a DTensor; "
                        "gather it or take its to_local() first")
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel for device {t.device}; use cuda or cpu")


def prefix_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis."""
    if _on_cuda(x):
        return _scan.prefix_scan_cuda(x)
    return ref.prefix_scan_ref(x)


def dispatch_work_prefix(expert_idx: torch.Tensor, weights: torch.Tensor,
                         n_experts: int, init: torch.Tensor | None = None):
    """``(prefix (R, T), fill (R, E))``: per row, ``init`` (R, E) (zeros if
    None) plus the weight of earlier same-destination tokens, and plus the
    per-destination totals, each destination's sum left to right (on the
    card two launches, counted as one)."""
    if _on_cuda(weights):
        return _dispatch.dispatch_work_prefix_cuda(expert_idx, weights,
                                                   n_experts, init)
    return ref.dispatch_work_prefix_ref(expert_idx, weights, n_experts, init)


def dispatch_positions(expert_idx: torch.Tensor, base: torch.Tensor,
                       n_experts: int):
    """``(pos (R, T), fill (R, E))`` int32: per row, each token's exclusive
    position within its expert counted from ``base`` (R, E), and the fills
    including ``base``; -1 (or any out-of-range expert) means none."""
    if _on_cuda(expert_idx):
        return _dispatch.dispatch_positions_cuda(expert_idx, base, n_experts)
    return ref.dispatch_positions_ref(expert_idx, base, n_experts)


def dispatch_positions_levels(topk_idx: torch.Tensor, n_experts: int,
                              capacity: int):
    """``(slot_idx (R, T, k), keep (R, T, k), filled (R, E))`` of a MoE
    layer's k priority levels ``topk_idx`` (R, T, k) int32 in one call (one
    launch on the card): level s counts from the previous level's fill
    clamped to ``capacity``, and ``filled`` is the kept count per expert
    (see ``ref.dispatch_positions_levels_ref``). On meta tensors the plain
    version's shapes and dtypes alone (nothing runs on meta)."""
    if _on_cuda(topk_idx):
        return _dispatch.dispatch_positions_levels_cuda(topk_idx, n_experts,
                                                        capacity)
    if topk_idx.device.type == "meta":
        slot_idx = torch.empty_like(topk_idx, dtype=torch.int32)
        return (slot_idx, slot_idx < capacity,
                topk_idx.new_empty((topk_idx.shape[0], n_experts),
                                   dtype=torch.int32))
    return ref.dispatch_positions_levels_ref(topk_idx, n_experts, capacity)


class _FlashAttention(torch.autograd.Function):
    """The index form on the card: the forward kernel with its log-sum-exp,
    the backward kernel for dq, dk, dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _flash.flash_attention_cuda(
            q, k, v, causal=causal, window=window, softcap=softcap,
            return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = _flash.flash_attention_bwd_cuda(
            q, k, v, dout.to(q.dtype), lse, causal=causal, window=window,
            softcap=softcap)
        return dq, dk, dv, None, None, None


class _MambaScan(torch.autograd.Function):
    """The selective scan on the card: the forward kernel, and the reverse
    kernel for its gradients."""

    @staticmethod
    def forward(ctx, da, dbx):
        h = _mamba.mamba_scan_cuda(da, dbx)
        ctx.save_for_backward(da, h)
        ctx.dtypes = (da.dtype, dbx.dtype)
        return h

    @staticmethod
    def backward(ctx, g):
        da, h = ctx.saved_tensors
        gda, gdbx = _mamba.mamba_scan_bwd_cuda(da, h, g.float().contiguous())
        return gda.to(ctx.dtypes[0]), gdbx.to(ctx.dtypes[1])


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    lengths=None):
    """Attention of q (B, H, S, hd) over k, v (B, KV, S, hd), output in
    ``q.dtype``: the index mask, or with ``lengths`` (B,) the mask of
    right-padded prompts of those real lengths, each in [1, S] (see
    ``ref.flash_attention_ref``). The index form is differentiable; the
    length form (prefill) raises when a gradient is asked for."""
    grad = _wants_grad(q, k, v)
    if grad and lengths is not None:
        raise ValueError("flash_attention's length form is not "
                         "differentiated (training runs the index form)")
    if _on_cuda(q):
        if grad:
            return _FlashAttention.apply(q, k, v, causal, window, softcap)
        return _flash.flash_attention_cuda(
            q, k, v, causal=causal, window=window, softcap=softcap,
            lengths=lengths)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, lengths=lengths)


def mamba_scan(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """The selective scan ``h_t = da_t * h_{t-1} + dbx_t`` over axis 1 of
    da, dbx (B, S, N, di), from h = 0; h in float32; differentiable. On
    meta tensors the plain version's shape, from one elementwise op over
    both inputs in place of its loop of S steps (nothing runs on meta)."""
    if _on_cuda(da):
        if _wants_grad(da, dbx):
            return _MambaScan.apply(da, dbx)
        return _mamba.mamba_scan_cuda(da, dbx)
    if da.device.type == "meta":
        return da.float() * dbx.float()
    return ref.mamba_scan_ref(da, dbx)


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel in this process; ``flash_attention``
    counts both forward flash kernels, ``flash_attention_tc`` the
    tensor-core (bfloat16) one alone, ``flash_attention_bwd`` and
    ``mamba_scan_bwd`` the backward calls (two launches and one),
    ``flash_attention_bwd_tc`` the backward calls on the tensor cores
    (bfloat16),
    ``dispatch_positions`` both position ops (one launch a call),
    ``dispatch_work_prefix`` one a call (two launches)."""
    return {"prefix_scan": _scan.LAUNCHES,
            "dispatch_work_prefix": _dispatch.LAUNCHES,
            "dispatch_positions": _dispatch.POSITION_LAUNCHES,
            "flash_attention": _flash.LAUNCHES,
            "flash_attention_tc": _flash.TC_LAUNCHES,
            "flash_attention_bwd": _flash.BWD_LAUNCHES,
            "flash_attention_bwd_tc": _flash.BWD_TC_LAUNCHES,
            "mamba_scan": _mamba.LAUNCHES,
            "mamba_scan_bwd": _mamba.BWD_LAUNCHES}


def reset_launch_counts() -> None:
    _scan.LAUNCHES = 0
    _dispatch.LAUNCHES = 0
    _dispatch.POSITION_LAUNCHES = 0
    _flash.LAUNCHES = 0
    _flash.TC_LAUNCHES = 0
    _flash.BWD_LAUNCHES = 0
    _flash.BWD_TC_LAUNCHES = 0
    _mamba.LAUNCHES = 0
    _mamba.BWD_LAUNCHES = 0
