"""Hand-written CUDA kernel: the selective scan of Mamba-1, ``h_t = da_t *
h_{t-1} + dbx_t`` over the sequence in float32. Source:
``csrc/mamba_scan.cu``, which replaces
``repro/kernels/mamba_scan.py::mamba_scan_pallas``.

One thread walks the sequence for a few consecutive channels of one (batch,
state) row, with h in registers; the loads of several time steps go out
before the dependent fma chain.

The backward (``mamba_scan_bwd`` in the same source,
:func:`mamba_scan_bwd_cuda`) walks the sequence in reverse with the same
thread layout: from da, the forward's h and the output gradient it writes
dL/dda and dL/ddbx.

``LAUNCHES`` counts the forward's launches in this process,
``BWD_LAUNCHES`` the backward's.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["mamba_scan_cuda", "mamba_scan_bwd_cuda", "LAUNCHES",
           "BWD_LAUNCHES"]

LAUNCHES = 0
BWD_LAUNCHES = 0

_SIGNATURES = {
    "mamba_scan_fwd": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p],
    "mamba_scan_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_void_p],
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


def mamba_scan_bwd_cuda(da: torch.Tensor, h: torch.Tensor,
                        g: torch.Tensor):
    """(dL/dda, dL/ddbx), both (B, S, N, di) float32, of ``h =
    mamba_scan_cuda(da, dbx)`` given ``g = dL/dh``: da float32 or bfloat16,
    h and g float32, all contiguous (B, S, N, di) on one CUDA device."""
    global BWD_LAUNCHES
    dev = da.device
    if dev.type != "cuda" or h.device != dev or g.device != dev:
        raise ValueError(f"mamba_scan_bwd_cuda needs da, h and g on one CUDA "
                         f"device, got {da.device}, {h.device}, {g.device}")
    if (da.dtype not in _DTYPES or h.dtype != torch.float32
            or g.dtype != torch.float32):
        raise TypeError(f"mamba_scan_bwd_cuda takes float32 or bfloat16 da "
                        f"and float32 h and g, got {da.dtype}, {h.dtype}, "
                        f"{g.dtype}")
    if da.dim() != 4 or h.shape != da.shape or g.shape != da.shape:
        raise ValueError(f"da, h and g must all be (B, S, N, di), got "
                         f"{tuple(da.shape)}, {tuple(h.shape)}, "
                         f"{tuple(g.shape)}")
    if not (da.is_contiguous() and h.is_contiguous() and g.is_contiguous()):
        raise ValueError("mamba_scan_bwd_cuda needs contiguous da, h and g")
    b, s, n, di = da.shape
    gda = torch.empty((b, s, n, di), dtype=torch.float32, device=dev)
    gdbx = torch.empty_like(gda)
    if gda.numel() == 0:
        return gda, gdbx
    lib = _build.load("mamba_scan", _SIGNATURES)
    err = lib.mamba_scan_bwd(
        _DTYPES[da.dtype], da.data_ptr(), h.data_ptr(), g.data_ptr(),
        gda.data_ptr(), gdbx.data_ptr(), b, s, n, di, dev.index,
        _build.stream_of(da))
    _build.check("mamba_scan", "mamba_scan_bwd", err)
    BWD_LAUNCHES += 1
    return gda, gdbx
