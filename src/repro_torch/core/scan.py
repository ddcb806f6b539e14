"""Prefix-scan primitives — the paper's core operator (Definition 3.1).

The paper builds everything on the exclusive additive scan ``(+, A)``:
load scans ``S = (+, L)`` and normalised-power scans ``lambda = (+, gamma)``.
This module provides

* host-side exact scans (numpy, used by the host schedulers),
* tensor scans (``torch``, on whatever device the tensor lies),
* a cross-rank scan ladder (``axis_exclusive_scan``) along one dimension
  of a ``DeviceMesh`` — the JAX package's ``ppermute`` ladder, on
  ``torch.distributed`` point-to-point sends (gloo or NCCL).

The batched engine's scans run through the hand-written kernel instead
(:func:`repro_torch.kernels.ops.prefix_scan`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "exclusive_scan_np",
    "inclusive_scan_np",
    "exclusive_scan",
    "inclusive_scan",
    "segment_positions",
    "axis_exclusive_scan",
    "axis_inclusive_scan",
]


# ---------------------------------------------------------------------------
# Host-side (numpy) scans — exact integer arithmetic for the host schedulers.
# ---------------------------------------------------------------------------

def exclusive_scan_np(a: np.ndarray, axis: int = -1) -> np.ndarray:
    """Exclusive additive scan: ``[0, a0, a0+a1, ...]`` (paper Def. 3.1)."""
    a = np.asarray(a)
    if a.size == 0:
        return np.zeros_like(a, dtype=np.result_type(a, np.float64)
                             if a.dtype.kind != "f" else a.dtype)
    out = np.cumsum(a, axis=axis)
    out = np.roll(out, 1, axis=axis)
    idx = [slice(None)] * out.ndim
    idx[axis if axis >= 0 else out.ndim + axis] = 0
    out[tuple(idx)] = 0
    return out


def inclusive_scan_np(a: np.ndarray, axis: int = -1) -> np.ndarray:
    return np.cumsum(np.asarray(a), axis=axis)


# ---------------------------------------------------------------------------
# Tensor scans.
# ---------------------------------------------------------------------------

def exclusive_scan(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exclusive additive scan along ``axis``."""
    return torch.cumsum(a, dim=axis, dtype=a.dtype) - a


def inclusive_scan(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.cumsum(a, dim=axis, dtype=a.dtype)


def segment_positions(segment_onehot: torch.Tensor) -> torch.Tensor:
    """Position of each element within its segment, given one-hot membership.

    ``segment_onehot``: (items, segments) 0/1. Returns (items, segments) where
    entry (i, s) is the number of earlier items in segment s — the per-segment
    exclusive scan the paper uses to index work units within a hyper-grid.
    """
    return exclusive_scan(segment_onehot, axis=0)


# ---------------------------------------------------------------------------
# Cross-rank scan along a mesh dimension.
# ---------------------------------------------------------------------------

def axis_exclusive_scan(x: torch.Tensor, mesh, axis_name: str):
    """Exclusive prefix sum of per-rank values across the ``axis_name``
    dimension of the ``DeviceMesh`` ``mesh`` (every rank of that dimension's
    group calls it with a tensor of one shape).

    Hillis-Steele doubling: ``ceil(log2(n))`` rounds in which the rank at
    index i of the group sends its partial sum to index i + shift and adds
    what index i - shift sent; a rank with no partner adds nothing. The JAX
    package's ladder adds in the same order, so the partial sums carry its
    bits. Also returns the total (the paper's "rightmost node broadcast"),
    an ``all_reduce`` whose order of adds is the backend's.

    Returns ``(exclusive, total)``; a dimension of size 1 gives
    ``(zeros, x)``.

    On a gloo group a device tensor's partial sums travel through host
    copies: gloo stages its collectives so, but its sends and receives
    hand the tensor's pointer to the socket, which on a device pointer
    aborts the process. The adds stay on the tensor's device.
    """
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if n == 1:
        return torch.zeros_like(x), x
    group = mesh.get_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    me = mesh.get_local_rank(axis_name)
    wire = torch.device("cpu") if dist.get_backend(group) == "gloo" \
        else x.device
    inc = x.contiguous()
    shift = 1
    while shift < n:
        ops = []
        if me + shift < n:
            ops.append(dist.P2POp(dist.isend, inc.to(wire),
                                  ranks[me + shift], group))
        got = None
        if me - shift >= 0:
            got = torch.empty_like(inc, device=wire)
            ops.append(dist.P2POp(dist.irecv, got, ranks[me - shift],
                                  group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if got is not None:
            inc = inc + got.to(inc.device)
        shift *= 2
    total = x.clone()
    dist.all_reduce(total, group=group)
    return inc - x, total


def axis_inclusive_scan(x: torch.Tensor, mesh, axis_name: str):
    exc, total = axis_exclusive_scan(x, mesh, axis_name)
    return exc + x, total
