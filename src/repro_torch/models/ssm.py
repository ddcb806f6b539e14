"""Mamba-1 selective-state-space block (falcon-mamba, jamba).

Train and prefill: the depthwise causal conv, then the selective scan
through ``kernels.ops.mamba_scan`` (the hand-written CUDA kernel for a CUDA
tensor, the plain version on the CPU). ``da`` and ``dbx`` are built directly
in the kernel's (B, S, N, di) layout, in place where that saves a copy: at
falcon-mamba-7b's prefill each is 4 GiB, and they are released before the
output contraction. The JAX package scans in (B, S, di, N) with a chunked
``associative_scan``; ``selective_scan_chunked`` keeps that layout and
chunking as the plain counterpart for the tests.

Decode: one state update against the carried (state, conv window) cache in
plain PyTorch; the JAX package runs no kernel there either.

Caches are written in place (``SSMCache`` of the caller's tensors), where
the JAX package returns updated copies.

Under a split over ``model`` (``ssm_train``'s ``split``, a
``models.distributed.ModelSplit`` with ``inner``) a rank runs di/m
channels: its block of ``conv_w``, ``conv_b``, ``dt_proj``, ``dt_bias``,
``A_log``, ``D``, ``x_proj``'s rows and ``out_proj``'s rows, and the scan
on them. ``in_proj`` (d, 2 di) is stored cut into m column blocks, which
do not hold a rank's channels of both halves, so the step gathers it whole
and takes the rank's columns of the x half and of the z half.
``x_proj`` contracts over the channels: its (B, S, dr + 2N) output is
all-reduced; ``out_proj`` is row-parallel. ``split_modes`` says how the
split uses each weight.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.ref import mamba_scan_ref
from .common import Dense, _param, reset_parameters
from .distributed import LOCAL, PARTS, columns

# the leaves cut along the channels: a rank keeps its channels' block
_CHANNEL_LEAVES = ("conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
                   "A_log", "D", "out_proj")

__all__ = ["Mamba", "SSMCache", "ssm_init", "ssm_train", "ssm_prefill",
           "ssm_decode", "selective_scan_chunked", "split_modes"]


class SSMCache(NamedTuple):
    state: torch.Tensor     # (..., B, d_inner, N)
    conv: torch.Tensor      # (..., B, K-1, d_inner): last K-1 pre-conv inputs

    @classmethod
    def zeros(cls, batch: int, d_inner: int, n_state: int, conv_k: int,
              dtype=torch.float32, device=None):
        return cls(
            torch.zeros((batch, d_inner, n_state), dtype=dtype, device=device),
            torch.zeros((batch, conv_k - 1, d_inner), dtype=dtype,
                        device=device))

    def write_slots(self, small: "SSMCache", idx: torch.Tensor) -> None:
        """Copy the prefill batch ``small`` into batch slots ``idx`` of this
        (n_stages, B, ...) cache, whole."""
        for big, part in zip(self, small):
            big[:, idx] = part


class Mamba(nn.Module):
    """``{"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
    "A_log", "D", "out_proj"}``; ``dt_bias``, ``A_log`` and ``D`` are
    float32 whatever the parameter dtype, as in the JAX package."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d, di, n, dr, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                           cfg.dt_rank, cfg.ssm_conv)
        f32 = torch.float32
        self.in_proj = Dense(d, 2 * di, dtype=dtype, device=device)
        self.conv_w = _param((k, di), dtype, device)
        self.conv_b = _param((di,), dtype, device)
        self.x_proj = Dense(di, dr + 2 * n, dtype=dtype, device=device)
        self.dt_proj = Dense(dr, di, scale=dr ** -0.5, dtype=dtype,
                             device=device)
        self.dt_bias = _param((di,), f32, device)
        self.A_log = _param((di, n), f32, device)
        self.D = _param((di,), f32, device)
        self.out_proj = Dense(di, d, scale=(di * 2 * cfg.n_layers) ** -0.5,
                              dtype=dtype, device=device)

    def draws(self, generator: torch.Generator, device):
        """``ssm_init``'s distributions: S4D-real ``A_log``, inverse-softplus
        ``dt_bias`` of dt log-uniform in [1e-3, 1e-1], ``conv_w`` normal x
        K^-1/2, truncated-normal projections, zero ``conv_b``, unit ``D``."""
        for layer in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            for name, value in getattr(self, layer).draws(generator, device):
                yield f"{layer}.{name}", value
        k, di = self.conv_w.shape
        n = self.A_log.shape[1]
        w = torch.empty((k, di), dtype=torch.float32, device=device)
        w.normal_(generator=generator)
        yield "conv_w", w * k ** -0.5
        yield "conv_b", torch.zeros((di,), device=device)
        u = torch.rand((di,), generator=generator, device=device)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo)
        yield "dt_bias", dt + torch.log(-torch.expm1(-dt))
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        yield "A_log", torch.log(a).expand(di, n)
        yield "D", torch.ones((di,), device=device)

    reset_parameters = reset_parameters


def ssm_init(generator, cfg, dtype=torch.float32, device=None) -> Mamba:
    m = Mamba(cfg, dtype=dtype, device=device)
    with torch.no_grad():
        m.reset_parameters(generator)
    return m


def _causal_depthwise_conv(x, w, b, conv_state=None):
    """x: (B, S, di); w: (K, di). Returns the conv output and the trailing
    K-1 inputs (the next conv state)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # (B, S+K-1, di)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_state = xp[:, xp.shape[1] - (k - 1):]
    return out + b, new_state


def _dt(p, xc, split=None):
    """xc (B, S, di) post-conv + silu -> (dt (B, S, di) float32, B, C (B, S,
    N) in xc's dtype). ``dt_proj`` runs in float32, as in the JAX package.
    With ``split``, xc holds this rank's channels: ``x_proj``'s partial
    product is summed over ``model`` and enters the split again."""
    dr = p["dt_proj"]["w"].shape[0]
    n = p["A_log"].shape[1]
    dbc = xc @ p["x_proj"]["w"].to(xc.dtype)            # (B, S, dr+2N)
    if split is not None:
        dbc = split.copy_to(split.reduce_from(dbc))
    dt_raw, b_mat, c_mat = torch.split(dbc, [dr, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() @ p["dt_proj"]["w"].float()
                    + p["dt_bias"])
    return dt, b_mat, c_mat


def _scan_inputs(p, xc, mask=None, split=None):
    """(da, dbx, C): da, dbx (B, S, N, di) float32 in the kernel's layout,
    written in place without autograd, as out-of-place products with it.
    With ``mask`` (B, S) False on padding, dt is 0 there, so da = 1 and dbx
    = 0 exactly: the identity transition of the JAX package's prefill."""
    dt, b_mat, c_mat = _dt(p, xc, split)
    if mask is not None:
        dt = dt * mask[..., None]
    a = -torch.exp(p["A_log"]).T                        # (N, di)
    b, s, di = dt.shape
    dt4 = dt[:, :, None, :]
    if torch.is_grad_enabled():     # training: the same products, in graph
        # (a broadcast product may follow a transposed input's strides; the
        # kernel takes the contiguous layout)
        da = torch.exp(dt4 * a).contiguous()
        dbx = (dt4 * b_mat.float()[..., None]
               * xc.float()[:, :, None, :]).contiguous()
        return da, dbx, c_mat
    da = torch.empty((b, s, a.shape[0], di), dtype=torch.float32,
                     device=dt.device)
    dbx = torch.empty_like(da)
    torch.exp(torch.mul(dt4, a, out=da), out=da)
    torch.mul(dt4, b_mat.float()[..., None], out=dbx)
    dbx.mul_(xc.float()[:, :, None, :])
    return da, dbx, c_mat


def _gate_out(p, y, xc, z, split=None):
    """(y + D x) gated by silu(z), through ``out_proj`` (row-parallel with
    ``split``)."""
    compute_dtype = z.dtype
    y = y + p["D"] * xc.float()
    y = y.to(compute_dtype) * F.silu(z)
    out = y @ p["out_proj"]["w"].to(compute_dtype)
    return out if split is None else split.reduce_from(out)


def _scan_out(h, c_mat):
    """``einsum("bsnd,bsn->bsd", h, C)`` as one batched product over (B, S),
    reading h in place."""
    return torch.matmul(c_mat.float().unsqueeze(-2), h).squeeze(-2)


def _mix_in(p, x, split=None):
    """x (B, S, d) -> (xr, z) halves of ``in_proj``, in x's dtype (this
    rank's channels of each with ``split``: its block of the x half's
    columns, then the same block of the z half's)."""
    w = p["in_proj"]["w"].to(x.dtype)
    if split is not None:
        w = columns(w, split.spans(w.shape[1], parts=2))
    xz = x @ w
    return xz.chunk(2, dim=-1)


def split_modes(split) -> dict:
    """How the split uses each weight (``models.distributed``): the
    per-channel leaves keep their shards, ``in_proj`` is gathered whole
    and the rank uses its channels' columns (parts)."""
    if not split.inner:
        return {}
    return {"in_proj": PARTS, **dict.fromkeys(_CHANNEL_LEAVES, LOCAL)}


def ssm_train(p, x, cfg, split=None):
    """The full-sequence forward. x: (B, S, d) -> (B, S, d). With
    ``split.inner`` the rank runs its channels (module docstring)."""
    compute_dtype = x.dtype
    split = split if split is not None and split.inner else None
    if split is not None:
        x = split.copy_to(x)
    xr, z = _mix_in(p, x, split)
    xc, _ = _causal_depthwise_conv(xr, p["conv_w"].to(compute_dtype),
                                   p["conv_b"].to(compute_dtype))
    xc = F.silu(xc)
    da, dbx, c_mat = _scan_inputs(p, xc, split=split)
    h = ops.mamba_scan(da, dbx)                         # (B, S, N, di) f32
    del da, dbx
    return _gate_out(p, _scan_out(h, c_mat), xc, z, split)


def ssm_prefill(p, x, cfg, cache: SSMCache, *, mask):
    """Prompt processing with state capture. mask: (B, S) bool, False on
    right padding, where steps are identity transitions, so ``h[:, S-1]``
    is the state after each sequence's last real token. Writes the state
    and the conv tail (the last K-1 pre-conv inputs of each sequence) into
    ``cache`` (B, di, N) / (B, K-1, di) in place. Returns (y, cache)."""
    compute_dtype = x.dtype
    k = cfg.ssm_conv
    xr, z = _mix_in(p, x)
    xr = xr * mask[..., None].to(compute_dtype)
    xc, _ = _causal_depthwise_conv(xr, p["conv_w"].to(compute_dtype),
                                   p["conv_b"].to(compute_dtype))
    xc = F.silu(xc)
    da, dbx, c_mat = _scan_inputs(p, xc, mask)
    h = ops.mamba_scan(da, dbx)
    del da, dbx
    cache.state.copy_(h[:, -1].transpose(1, 2))
    y = _gate_out(p, _scan_out(h, c_mat), xc, z)
    del h
    lengths = mask.sum(dim=1)                            # (B,)
    idx = (lengths[:, None] - (k - 1)
           + torch.arange(k - 1, device=x.device)[None, :])
    gathered = torch.take_along_dim(xr, idx.clamp_min(0)[..., None], dim=1)
    cache.conv.copy_(torch.where((idx >= 0)[..., None], gathered,
                                 torch.zeros((), dtype=xr.dtype,
                                             device=x.device)))
    return y, cache


def ssm_decode(p, x, cfg, cache: SSMCache):
    """One-token decode. x: (B, 1, d). Updates ``cache`` in place; returns
    (y, cache)."""
    compute_dtype = x.dtype
    xr, z = _mix_in(p, x)                               # (B, 1, di)
    xc, conv_state = _causal_depthwise_conv(
        xr, p["conv_w"].to(compute_dtype), p["conv_b"].to(compute_dtype),
        conv_state=cache.conv)
    xc = F.silu(xc)
    dt, b_mat, c_mat = _dt(p, xc)                       # (B, 1, ...)
    a = -torch.exp(p["A_log"])                          # (di, N)
    da = torch.exp(dt[:, 0, :, None] * a)               # (B, di, N)
    dbx = (dt[:, 0, :, None] * b_mat[:, 0, None, :].float()
           * xc[:, 0, :, None].float())
    h = da * cache.state.float() + dbx
    y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0].float())
    y = _gate_out(p, y[:, None], xc, z)
    cache.state.copy_(h)
    cache.conv.copy_(conv_state)
    return y, cache


def selective_scan_chunked(da, dbx, h0=None, chunk: int = 256):
    """The JAX package's blocked scan in its (B, S, di, N) layout: chunks of
    ``chunk`` steps in order, each from the previous chunk's last state, by
    the plain ``mamba_scan_ref``. Returns (h (B, S, di, N) float32, h_last
    (B, di, N))."""
    b, s, di, n = da.shape
    h = torch.empty((b, s, di, n), dtype=torch.float32, device=da.device)
    carry = (torch.zeros((b, n, di), dtype=torch.float32, device=da.device)
             if h0 is None else h0.float().transpose(1, 2))
    for t0 in range(0, s, max(chunk, 1)):
        part = mamba_scan_ref(da[:, t0:t0 + chunk].transpose(2, 3),
                              dbx[:, t0:t0 + chunk].transpose(2, 3), carry)
        h[:, t0:t0 + chunk] = part.transpose(2, 3)
        carry = part[:, -1]
    return h, carry.transpose(1, 2)
