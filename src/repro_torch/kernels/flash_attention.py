"""Hand-written CUDA kernel: flash attention forward (online softmax, GQA,
causal, optional sliding window and tanh soft-cap, float32 accumulation).
Source: ``csrc/flash_attention.cu``, which replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``.

Beyond the Pallas kernel's index mask it takes the model's position mask
(``q_positions``/``kv_positions``, -1 on right padding), which the LM's
prefill needs: a padded query then attends to key 0 only, as in
``repro.models.attention.chunked_attention``, and its output (which goes on
through the MoE router and takes expert capacity) matches the JAX model's.

``LAUNCHES`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_cuda", "LAUNCHES"]

LAUNCHES = 0

_SIGNATURES = {
    "flash_attention_fwd": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                            ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                            ctypes.c_int, ctypes.c_void_p],
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when every row of its head dimension starts on 16 bytes
    with the head dimension contiguous (what the kernel's vector loads need),
    else a fresh contiguous copy."""
    item = x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s * item % 16 == 0 for s in x.stride()[:-1])):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention_cuda(q, k, v, *, causal=True, window=None, softcap=None,
                         q_positions=None, kv_positions=None):
    """q (B, H, S, hd), k and v (B, KV, S, hd) on one CUDA device, float32
    or bfloat16 alike, H % KV == 0, hd <= 256 and a multiple of 8; any
    strides with the head dimension contiguous (the model passes permuted
    (B, S, H, hd) views). Returns (B, H, S, hd) in ``q.dtype``, laid out as
    a permuted (B, S, H, hd) tensor.

    ``q_positions``/``kv_positions`` (B, S) int32 select the position mask
    (both or neither); they must satisfy ``q_pos[i] <= i`` and ``kv_pos[j]
    in {j, -1}``, as right-padded prefill gives them."""
    global LAUNCHES
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16 "
                        f"q, k, v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, H, S, hd) and k, v (B, KV, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, hd) or h % kvh:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B, S, hd; H % KV == 0)")
    if hd > 256 or hd % 8:
        raise ValueError(f"head_dim must be a multiple of 8 up to 256, "
                         f"got {hd}")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the grid's 65,535")
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("give both q_positions and kv_positions, or neither")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if q_positions is not None:
        q_positions = q_positions.to(device=dev, dtype=torch.int32)
        kv_positions = kv_positions.to(device=dev, dtype=torch.int32)
        if q_positions.shape != (b, s) or kv_positions.shape != (b, s):
            raise ValueError(f"positions must be (B, S) = {(b, s)}, got "
                             f"{tuple(q_positions.shape)} and "
                             f"{tuple(kv_positions.shape)}")
        q_positions = q_positions.contiguous()
        kv_positions = kv_positions.contiguous()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    out = out.permute(0, 2, 1, 3)
    if b == 0 or s == 0:
        return out
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(),
        None if q_positions is None else q_positions.data_ptr(),
        None if kv_positions is None else kv_positions.data_ptr(),
        b, h, kvh, s, hd, strides, hd ** -0.5, int(bool(causal)),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), dev.index,
        _build.stream_of(q))
    _build.check("flash_attention", "flash_attention", err)
    LAUNCHES += 1
    return out
