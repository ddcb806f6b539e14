"""Attention: GQA/MQA/MHA with RoPE or sinusoidal positions, optional QKV
bias, logit soft-capping (grok), sliding-window + global mix (gemma3).

Two execution paths, as in the JAX package:

* train/prefill — the flash schedule, through ``kernels.ops.flash_attention``:
  the hand-written CUDA kernel for a CUDA tensor, the plain version on the
  CPU. Prefill passes the model's position mask (-1 on right padding).
* decode — one query token against the KV cache: a masked product in plain
  PyTorch, memory-bound by design (no TPU kernel computes it either).

Layout at every public function is the JAX package's: q (B, S, H, hd), k
and v (B, S, KV, hd), caches (B, L, KV, hd).

Under a split over ``model`` (``attn_train``'s ``split``, a
``models.distributed.ModelSplit`` with ``heads``) a rank projects and
attends its H/m query heads, from its columns of ``wq``, and its rows of
``wo`` make the output a partial sum, all-reduced. Where the KV heads
split too (``kv_heads``) it projects its KV/m heads; where they do not, it
projects the KV heads its query heads read, from their columns of the
whole ``wk`` and ``wv`` (``local_kv_heads``), so the kernel sees GQA's
head-to-group map of the whole model. ``split_modes`` says how the split
uses each weight. The caches are written in
place (prefill fills rows ``[0, S)``, decode row ``lengths``), where the
JAX package returns updated copies: the serving engine's caches are the
largest tensors on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..kernels import ops
from ..kernels.ref import flash_attention_ref
from .common import Dense, dense, dense_row, reset_parameters, rope
from .distributed import LOCAL, PARTS, WHOLE, columns

__all__ = ["Attention", "KVCache", "attn_init", "attn_train", "attn_prefill",
           "attn_decode", "chunked_attention", "local_kv_heads",
           "split_modes"]

_NEG = -2.0 ** 30  # large-negative mask value safe in bf16/f32


class KVCache(NamedTuple):
    k: torch.Tensor        # (..., B, L, KV, hd)
    v: torch.Tensor

    @classmethod
    def zeros(cls, batch: int, max_len: int, n_kv: int, head_dim: int,
              dtype=torch.bfloat16, device=None):
        shape = (batch, max_len, n_kv, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def write_slots(self, small: "KVCache", idx: torch.Tensor) -> None:
        """Copy the prefill batch ``small`` (n_stages, b, S, KV, hd) into
        batch slots ``idx`` of this (n_stages, B, L, KV, hd) cache: rows
        [0, S) from ``small``, the rows beyond zeroed, as the JAX engine's
        full-length scratch leaves them."""
        s = small.k.shape[2]
        for big, part in zip(self, small):
            big[:, idx, :s] = part
            big[:, idx, s:] = 0


class Attention(nn.Module):
    """``{"wq", "wk", "wv", "wo"}`` dense layers."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wq = Dense(d, cfg.n_heads * hd, **kw)
        self.wk = Dense(d, cfg.n_kv_heads * hd, **kw)
        self.wv = Dense(d, cfg.n_kv_heads * hd, **kw)
        self.wo = Dense(cfg.n_heads * hd, d,
                        scale=(cfg.n_heads * hd * 2 * cfg.n_layers) ** -0.5,
                        dtype=dtype, device=device)

    reset_parameters = reset_parameters


def attn_init(generator, cfg, dtype=torch.float32, device=None) -> Attention:
    a = Attention(cfg, dtype=dtype, device=device)
    with torch.no_grad():
        a.reset_parameters(generator)
    return a


def _softcap(logits, cap):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _project_qkv(p, x, cfg, positions, compute_dtype):
    """q, k, v over the heads the weights hold (all, or a rank's)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = dense(p["wq"], x, compute_dtype).reshape(b, s, -1, hd)
    k = dense(p["wk"], x, compute_dtype).reshape(b, s, -1, hd)
    v = dense(p["wv"], x, compute_dtype).reshape(b, s, -1, hd)
    if cfg.pos_embed == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _flash(q, k, v, *, window, softcap, lengths=None):
    """ops.flash_attention on the model's (B, S, H, hd) layout."""
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, softcap=softcap, lengths=lengths)
    return out.transpose(1, 2)                  # (B, S, H, hd)


def chunked_attention(q, k, v, *, q_positions, kv_positions, window=None,
                      is_global=True, softcap=None):
    """The plain counterpart of the JAX package's ``chunked_attention``:
    causal by position, keys with position -1 masked, an optional sliding
    window unless ``is_global``. q (B, S, H, hd); k, v (B, S, KV, hd).
    Computed by the flash kernel's plain version (the full softmax gives the
    online softmax's result up to float rounding)."""
    out = flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=None if is_global else window, softcap=softcap,
        q_positions=q_positions, kv_positions=kv_positions)
    return out.transpose(1, 2)


def split_modes(split) -> dict:
    """How the split uses each weight (``models.distributed``): ``wq``
    and ``wo`` keep their shards of the rank's query heads, ``wk`` and
    ``wv`` theirs where the KV heads split too, else they are gathered
    whole and the rank uses its heads' groups' columns (parts)."""
    heads = LOCAL if split.heads else WHOLE
    kv = LOCAL if split.kv_heads else PARTS if split.heads else WHOLE
    return {"wq": heads, "wo": heads, "wk": kv, "wv": kv}


def local_kv_heads(cfg, split) -> tuple[int, int, torch.Tensor | None]:
    """Where the KV heads do not split over ``model``: (first, count) of
    the KV heads a rank's H/m query heads read, and ``None`` where they
    all lie in the one group, else each query head's own KV head among
    them (the rank's attention is then multi-head over them)."""
    n_local = cfg.n_heads // split.size
    rep = cfg.n_heads // cfg.n_kv_heads
    first_q = split.block(n_local)
    first = first_q // rep
    count = (first_q + n_local - 1) // rep + 1 - first
    if count == 1:
        return first, 1, None
    return first, count, torch.arange(first_q, first_q + n_local) // rep \
        - first


def attn_train(p, x, cfg, *, positions=None, is_global=True, split=None):
    """Self-attention over a full sequence (train / prefill without
    padding): positions 0..S-1, the flash kernel's index mask. With
    ``split.heads`` the weights are this rank's heads' (module
    docstring)."""
    compute_dtype = x.dtype
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    tp = split is not None and split.heads
    index = None
    if tp:
        x = split.copy_to(x)
        if not split.kv_heads:
            first, count, index = local_kv_heads(cfg, split)
            hd = [(first * cfg.head_dim_, count * cfg.head_dim_)]
            p = {**p, **{key: {k: columns(w, hd) for k, w in p[key].items()}
                         for key in ("wk", "wv")}}
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    if index is not None:
        index = index.to(k.device)
        k, v = k[:, :, index], v[:, :, index]
    out = _flash(q, k, v, window=None if is_global else cfg.sliding_window,
                 softcap=cfg.attn_logit_softcap)
    if tp:
        return dense_row(p["wo"], out.reshape(b, s, -1), split,
                         compute_dtype)
    return dense(p["wo"], out.reshape(b, s, -1), compute_dtype)


def attn_prefill(p, x, cfg, cache: KVCache, *, lengths, is_global=True):
    """Prompt processing: full self-attention AND KV-cache population.

    lengths: (B,) int32 real lengths of the right-padded prompts, each in
    [1, S]; the JAX package's positions are ``j`` below the length and -1
    beyond (padded keys are masked, a padded query sees key 0 only, the
    cache rows beyond each sequence's length are never read by decode).
    Writes rows ``[0, S)`` of ``cache`` (B, L, KV, hd) in place. Returns
    (y, cache).
    """
    compute_dtype = x.dtype
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    safe_pos = torch.where(pos < lengths[:, None], pos, 0)
    q, k, v = _project_qkv(p, x, cfg, safe_pos, compute_dtype)
    out = _flash(q, k, v, window=None if is_global else cfg.sliding_window,
                 softcap=cfg.attn_logit_softcap, lengths=lengths)
    y = dense(p["wo"], out.reshape(b, s, -1), compute_dtype)
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    return y, cache


def attn_decode(p, x, cfg, cache: KVCache, lengths, *, is_global=True):
    """One-token decode against the KV cache.

    x: (B, 1, d); lengths: (B,) current length per sequence (the new token's
    position). Writes row ``lengths`` of ``cache`` in place. Returns (y,
    cache).
    """
    compute_dtype = x.dtype
    b = x.shape[0]
    hd = cfg.head_dim_
    positions = lengths[:, None]                       # (B, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, compute_dtype)
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, lengths] = k_new[:, 0].to(cache.k.dtype)
    cache.v[bidx, lengths] = v_new[:, 0].to(cache.v.dtype)

    kvh = cfg.n_kv_heads
    rep = cfg.n_heads // kvh
    qg = q.reshape(b, kvh, rep, hd)
    logits = torch.einsum("bkrh,btkh->bkrt", qg,
                          cache.k.to(compute_dtype)).float()
    logits = _softcap(logits * hd ** -0.5, cfg.attn_logit_softcap)
    t = torch.arange(cache.k.shape[1], device=x.device)
    mask = t[None, :] <= lengths[:, None]              # (B, L)
    if cfg.sliding_window is not None and not is_global:
        mask = mask & ((lengths[:, None] - t[None, :]) < cfg.sliding_window)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), _NEG, device=x.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrt,btkh->bkrh", w.to(compute_dtype),
                       cache.v.to(compute_dtype))
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return dense(p["wo"], out, compute_dtype), cache
