"""Prefix-scan primitives — the paper's core operator (Definition 3.1).

The paper builds everything on the exclusive additive scan ``(+, A)``:
load scans ``S = (+, L)`` and normalised-power scans ``lambda = (+, gamma)``.
This module provides

* host-side exact scans (numpy, used by the host schedulers),
* tensor scans (``torch``, on whatever device the tensor lies).

The batched engine's scans run through the hand-written kernel instead
(:func:`repro_torch.kernels.ops.prefix_scan`). The cross-device scan ladder
of the JAX package (``axis_exclusive_scan``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "exclusive_scan_np",
    "inclusive_scan_np",
    "exclusive_scan",
    "inclusive_scan",
    "segment_positions",
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
