"""Hand-written CUDA kernel: the selective scan of Mamba-1, ``h_t = da_t *
h_{t-1} + dbx_t`` over the sequence in float32. Source:
``csrc/mamba_scan.cu``, which replaces
``repro/kernels/mamba_scan.py::mamba_scan_pallas``.

One thread walks the sequence for a few consecutive channels of one (batch,
state) row, with h in registers; the loads of several time steps go out
before the dependent fma chain.

``LAUNCHES`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["mamba_scan_cuda", "LAUNCHES"]

LAUNCHES = 0

_SIGNATURES = {
    "mamba_scan_fwd": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p],
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mamba_scan_cuda(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """da, dbx (B, S, N, di) contiguous on one CUDA device, both float32 or
    both bfloat16. Returns h (B, S, N, di) float32, from h = 0."""
    global LAUNCHES
    dev = da.device
    if dev.type != "cuda" or dbx.device != dev:
        raise ValueError(f"mamba_scan_cuda needs da and dbx on one CUDA "
                         f"device, got {da.device} and {dbx.device}")
    if da.dtype not in _DTYPES or dbx.dtype != da.dtype:
        raise TypeError(f"mamba_scan_cuda takes float32 or bfloat16 da and "
                        f"dbx of one type, got {da.dtype} and {dbx.dtype}")
    if da.dim() != 4 or dbx.shape != da.shape:
        raise ValueError(f"da and dbx must both be (B, S, N, di), got "
                         f"{tuple(da.shape)} and {tuple(dbx.shape)}")
    if not (da.is_contiguous() and dbx.is_contiguous()):
        raise ValueError("mamba_scan_cuda needs contiguous da and dbx")
    b, s, n, di = da.shape
    out = torch.empty((b, s, n, di), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("mamba_scan", _SIGNATURES)
    err = lib.mamba_scan_fwd(
        _DTYPES[da.dtype], da.data_ptr(), dbx.data_ptr(), out.data_ptr(), b,
        s, n, di, dev.index, _build.stream_of(da))
    _build.check("mamba_scan", "mamba_scan", err)
    LAUNCHES += 1
    return out
