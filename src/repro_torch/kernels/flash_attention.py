"""Hand-written CUDA kernels: flash attention forward (online softmax, GQA,
causal, optional sliding window and tanh soft-cap, float32 accumulation).
Source: ``csrc/flash_attention.cu``, which replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``. Two kernels,
picked by dtype: bfloat16 inputs run on the tensor cores (``mma.sync``,
cp.async double buffering); float32 inputs keep the float32-FMA kernel,
since TF32 products would miss the float32 callers' 2e-5 tolerance.

Beyond the Pallas kernel's index mask both take the prompts' real
``lengths``, the mask of the LM's prefill over right-padded prompts: a
padded query then attends to key 0 only, as in
``repro.models.attention.chunked_attention``, and its output (which goes on
through the MoE router and takes expert capacity) matches the JAX model's.
Both visit only the KV tiles of :func:`tile_plan`; a causal bfloat16 query
tile wholly in the padding copies V's row 0, the one key its rows see.

The backward (``csrc/flash_attention_bwd.cu``, :func:`flash_attention_bwd_cuda`)
gives dQ, dK and dV of the index form from q, k, v, the output's gradient
and the forward's per-row log-sum-exp, which both forward kernels write when
asked (``return_lse``); it recomputes P under the same mask and tile plan
(two launches: dQ per query tile, which also writes the softmax backward's
row sums, then dK/dV per key tile). bfloat16 runs on the tensor cores
(``flash_bwd_dq_tc``, ``flash_bwd_dkdv_tc``), float32 on float32 FMAs; the
tiles of each are :func:`bwd_tiles`, the walks :func:`tile_plan` (dQ) and
:func:`bwd_key_plan` (dK/dV).

``LAUNCHES`` counts every launch of either forward kernel in this process,
``TC_LAUNCHES`` those of the tensor-core kernel, ``BWD_LAUNCHES`` the
backward's calls (two launches each, counted as one) and
``BWD_TC_LAUNCHES`` those on the tensor cores.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import check_lengths

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "tile_plan",
           "bwd_tiles", "bwd_key_plan", "cuda_tile_plan", "cuda_bwd_tiles",
           "cuda_bwd_tile_plan", "cuda_bwd_key_plan", "LAUNCHES",
           "TC_LAUNCHES", "BWD_LAUNCHES", "BWD_TC_LAUNCHES"]

LAUNCHES = 0
TC_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_TC_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int,
             ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_KERNELS = {torch.bfloat16: "flash_attention_tc",
            torch.float32: "flash_attention_f32"}
_SIGNATURES = {name: _ARGTYPES for name in _KERNELS.values()}
_SIGNATURES["flash_tile_plan"] = [ctypes.c_int] * 7 + [
    ctypes.POINTER(ctypes.c_int), ctypes.c_int]
_BWD_SIGNATURES = {
    "flash_attention_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_int64] * 5 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                              ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p],
    "flash_bwd_tiles": [ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int)],
    "flash_bwd_tile_plan": [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int],
    "flash_bwd_key_plan": [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]}
_BWD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tile_plan(q0: int, block_q: int, block_k: int, S: int, L: int,
              causal: bool, window: int | None) -> list[int]:
    """The first keys of the KV tiles, of ``block_k`` keys each, that the
    query block of rows ``[q0, min(q0 + block_q, S))`` visits, in the
    kernels' order (``make_plan`` in ``csrc/flash_attention.cu``).

    ``L`` is the sequence's real length: S in the index form, L_b in the
    length form, whose mask is right-padded prefill's (``kv_pos[j] = j``
    for ``j < L``, -1 beyond, ``q_pos = max(pos, 0)``, ``L >= 1``). Real
    rows need the keys from the window's left edge to the causal frontier
    (to L without causality); padded rows see key 0 only (every key below L
    without causality). Tile 0 comes first when the block holds padded
    rows.

    The rule the CUDA kernels follow, stated for the CPU tests, which hold
    it against the plain version's mask; the card tests hold it against
    the kernels' own rule (``flash_tile_plan`` in the library). Nothing on
    the path calls it."""
    q1 = min(q0 + block_q, S)
    real_end = min(q1, L)
    n_pad = first = last = 0
    if max(q0, L) < q1:
        n_pad = -(-(1 if causal else L) // block_k)
    if q0 < real_end:
        first = (max(0, q0 - window + 1) if window else 0) // block_k
        last = -(-(real_end if causal else L) // block_k)
    first = max(first, n_pad)
    tiles = list(range(n_pad)) + list(range(first, max(first, last)))
    return [t * block_k for t in tiles]


def bwd_tiles(dtype: torch.dtype, hd: int) -> tuple[int, int]:
    """``(block_q, block_k)`` of the backward kernels for ``dtype`` at head
    width ``hd``: query tiles of ``block_q`` rows (a dQ block's, and the
    tiles a dK/dV block walks), key tiles of ``block_k`` (a dK/dV block's,
    and the tiles a dQ block walks). bfloat16 (``Tune<HD>`` in
    ``csrc/flash_attention_bwd.cu``): 64 x 64 up to hd 128, 32 queries x 64
    keys above; float32: 64 x 64 up to hd 128, 32 x 32 above."""
    if dtype == torch.bfloat16:
        return (64, 64) if hd <= 128 else (32, 64)
    return (64, 64) if hd <= 128 else (32, 32)


def bwd_key_plan(k0: int, block_q: int, block_k: int, S: int, causal: bool,
                 window: int | None) -> list[int]:
    """The first rows of the query tiles, of ``block_q`` rows, that the
    backward's dK/dV kernel walks for the key tile at ``k0``: those whose
    :func:`tile_plan` (index form) holds it, in order (``key_walk`` in
    ``csrc/flash_attention_bwd.cu``). The dQ kernel walks
    ``tile_plan(q0, block_q, block_k, S, S, causal, window)``, so both
    visit the same (query tile, key tile) pairs. Stated for the CPU tests;
    nothing on the path calls it."""
    return [q0 for q0 in range(0, S, block_q)
            if k0 in tile_plan(q0, block_q, block_k, S, S, causal, window)]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when every row of its head dimension starts on 16 bytes
    with the head dimension contiguous (what the kernel's vector loads need),
    else a fresh contiguous copy."""
    item = x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s * item % 16 == 0 for s in x.stride()[:-1])):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_inputs(q, k, v, window, softcap, who):
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{who} takes q, k, v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{who} needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
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
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def flash_attention_cuda(q, k, v, *, causal=True, window=None, softcap=None,
                         lengths=None, return_lse=False):
    """q (B, H, S, hd), k and v (B, KV, S, hd) on one CUDA device, float32
    or bfloat16 alike, H % KV == 0, hd <= 256 and a multiple of 8; any
    strides with the head dimension contiguous (the model passes permuted
    (B, S, H, hd) views). Returns (B, H, S, hd) in ``q.dtype``, laid out as
    a permuted (B, S, H, hd) tensor.

    ``lengths`` (B,) integers, each in [1, S], selects the length form:
    right-padded prompts of ``lengths[b]`` real tokens (see
    ``ref.flash_attention_ref``'s ``lengths``). A CPU tensor's values are
    checked; a card tensor's are not (that would sync), and the kernels
    clamp them to [1, S]. The kernels visit only the KV tiles that the mask
    admits (:func:`tile_plan`).

    ``return_lse`` (index form only) also returns the (B, H, S) float32
    log-sum-exp of each query row's logits, the backward's input."""
    global LAUNCHES, TC_LAUNCHES
    entry = _KERNELS.get(q.dtype)
    if entry is None:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                        f"got {q.dtype}")
    _check_inputs(q, k, v, window, softcap, "flash_attention_cuda")
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    dev = q.device
    if lengths is not None:
        if return_lse:
            raise ValueError("the length form gives no log-sum-exp: the "
                             "backward takes the index form")
        check_lengths(lengths, b, s, values=lengths.device.type == "cpu")
        lengths = lengths.to(device=dev, dtype=torch.int32)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    out = out.permute(0, 2, 1, 3)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=dev)
           if return_lse else None)
    if b == 0 or s == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _build.load("flash_attention", _SIGNATURES)
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, kvh, s, hd,
        strides, hd ** -0.5, int(bool(causal)),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), dev.index,
        _build.stream_of(q))
    _build.check("flash_attention", entry, err)
    LAUNCHES += 1
    if entry == "flash_attention_tc":
        TC_LAUNCHES += 1
    return (out, lse) if return_lse else out


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its head dimension is contiguous, else a copy."""
    return x if x.stride(-1) == 1 else x.contiguous()


def flash_attention_bwd_cuda(q, k, v, dout, lse, *, causal=True,
                             window=None, softcap=None):
    """(dq, dk, dv) of the index form of :func:`flash_attention_cuda` at q
    (B, H, S, hd), k, v (B, KV, S, hd), given the output's gradient
    ``dout`` (B, H, S, hd) and the forward's ``lse`` (B, H, S) float32;
    float32 or bfloat16 alike, any strides with the head dimension
    contiguous. The gradients come in the input type, dq laid out
    as a permuted (B, S, H, hd) tensor and dk, dv as permuted (B, S, KV,
    hd) ones, the layout of the model's projections. bfloat16 runs on the
    tensor-core kernels, float32 on the FMA ones."""
    global BWD_LAUNCHES, BWD_TC_LAUNCHES
    if q.dtype not in _BWD_DTYPES:
        raise TypeError(f"flash_attention_bwd_cuda takes float32 or "
                        f"bfloat16, got {q.dtype}")
    _check_inputs(q, k, v, window, softcap, "flash_attention_bwd_cuda")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must be q's shape {tuple(q.shape)} and type "
                         f"{q.dtype}, got {tuple(dout.shape)} {dout.dtype}")
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    dev = q.device
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != dev or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 ({b}, {h}, {s}) "
                         f"tensor on {dev}")
    # the tensor-core kernels copy 16-byte pieces of each row
    fix = _aligned if q.dtype == torch.bfloat16 else _rows
    q, k, v, dout = (fix(t) for t in (q, k, v, dout))
    dq = torch.empty((b, s, h, hd), dtype=q.dtype,
                     device=dev).permute(0, 2, 1, 3)
    dk = torch.empty((b, s, kvh, hd), dtype=q.dtype,
                     device=dev).permute(0, 2, 1, 3)
    dv = torch.empty_like(dk)
    if b == 0 or s == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    tensors = (q, k, v, dout, dq, dk, dv)
    strides = (ctypes.c_int64 * 21)(*(st for t in tensors
                                      for st in t.stride()[:3]))
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    err = lib.flash_attention_bwd(
        _BWD_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, s, hd,
        strides, hd ** -0.5, int(bool(causal)),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), dev.index,
        _build.stream_of(q))
    _build.check("flash_attention_bwd", "flash_attention_bwd", err)
    BWD_LAUNCHES += 1
    if q.dtype == torch.bfloat16:
        BWD_TC_LAUNCHES += 1
    return dq, dk, dv


def cuda_tile_plan(q0: int, block_q: int, block_k: int, S: int, L: int,
                   causal: bool, window: int | None) -> list[int]:
    """:func:`tile_plan` as the CUDA library computes it (``make_plan``,
    which both kernels run, called on the host); builds the library, so it
    needs ``nvcc``."""
    lib = _build.load("flash_attention", _SIGNATURES)
    cap = -(-S // block_k) + 1
    starts = (ctypes.c_int * cap)()
    n = lib.flash_tile_plan(q0, block_q, block_k, S, L, int(bool(causal)),
                            window or 0, starts, cap)
    if not 0 <= n <= cap:
        raise RuntimeError(f"flash_tile_plan gave {n} tiles (at most {cap})")
    return list(starts[:n])


def cuda_bwd_tiles(dtype: torch.dtype, hd: int) -> tuple[int, int]:
    """The backward kernels' (query tile, key tile) for ``dtype`` at head
    width ``hd``, as the CUDA library states them (``flash_bwd_tiles``).
    Builds the library, so it needs ``nvcc``."""
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    out = (ctypes.c_int * 2)()
    _build.check("flash_attention_bwd", "flash_bwd_tiles",
                 lib.flash_bwd_tiles(_BWD_DTYPES[dtype], hd, out))
    return out[0], out[1]


def _plan(fn: str, start: int, block_q: int, block_k: int, S: int,
          causal: bool, window: int | None, cap: int) -> list[int]:
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    starts = (ctypes.c_int * cap)()
    n = getattr(lib, fn)(start, block_q, block_k, S, int(bool(causal)),
                         window or 0, starts, cap)
    if not 0 <= n <= cap:
        raise RuntimeError(f"{fn} gave {n} tiles (at most {cap})")
    return list(starts[:n])


def cuda_bwd_tile_plan(q0: int, block_q: int, block_k: int, S: int,
                       causal: bool, window: int | None) -> list[int]:
    """The key tiles the backward's dQ kernels visit for query rows ``[q0,
    min(q0 + block_q, S))`` (their ``make_plan``, run on the host): the
    index form of :func:`tile_plan`. Builds the library, so it needs
    ``nvcc``."""
    return _plan("flash_bwd_tile_plan", q0, block_q, block_k, S, causal,
                 window, -(-S // block_k) + 1)


def cuda_bwd_key_plan(k0: int, block_q: int, block_k: int, S: int,
                      causal: bool, window: int | None) -> list[int]:
    """The query tiles the backward's dK/dV kernels walk for the key tile at
    ``k0`` (their ``key_walk``, run on the host): :func:`bwd_key_plan`.
    Builds the library, so it needs ``nvcc``."""
    return _plan("flash_bwd_key_plan", k0, block_q, block_k, S, causal,
                 window, -(-S // block_q) + 1)
