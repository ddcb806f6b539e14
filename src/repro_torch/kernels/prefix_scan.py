"""Hand-written CUDA kernel: row-wise exclusive prefix scan in float64 (the
paper's core operator, Definition 3.1). Source: ``csrc/prefix_scan.cu``,
which replaces ``repro/kernels/prefix_scan.py::prefix_scan_pallas``.

``LAUNCHES`` counts the kernel's launches in this process, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["prefix_scan_cuda", "LAUNCHES"]

LAUNCHES = 0

_SIGNATURES = {
    "prefix_scan_f64": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
}


def prefix_scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis of a contiguous float64
    CUDA tensor; the leading axes are rows."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"prefix_scan_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float64:
        raise TypeError(f"prefix_scan_cuda takes float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("prefix_scan_cuda needs a contiguous tensor")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n = x.shape[-1]
    lib = _build.load("prefix_scan", _SIGNATURES)
    err = lib.prefix_scan_f64(x.data_ptr(), out.data_ptr(), x.numel() // n, n,
                              x.device.index, _build.stream_of(x))
    _build.check("prefix_scan", "prefix_scan", err)
    LAUNCHES += 1
    return out
