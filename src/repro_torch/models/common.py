"""Shared model building blocks: norms, embeddings, RoPE, init.

The layers hold their parameters in ``nn.Module``s under the JAX package's
dict keys (``w``/``b`` of a dense layer, ``scale``/``bias`` of a norm), so a
JAX parameter pytree maps onto a state dict by joining keys with dots
(``models.convert``). The computation is plain functions over nested dicts
of tensors with the same keys, as in the JAX package: ``dense(p, x)`` with
``p = {"w": ...}``. Initialisers take an explicit ``torch.Generator``: a
layer's ``draws`` gives its initial values one leaf at a time (``draws``
walks a model's layers in order), and ``reset_parameters`` copies them in.

``logical_axis_rules`` binds logical-axis -> mesh-axis rules (``launch.
shardings.activation_rules``) for the duration of a ``with`` block, as the
JAX package's does; the sharded train step reads the ``batch`` axes it
splits the batch over from them when it is built. The JAX package's
``shard`` (an activation sharding constraint for XLA) has no counterpart:
the port's sharded step gathers weights, splits the batch and splits the
compute over ``model`` itself (``models.distributed``). There a
column-parallel product is ``dense`` on a weight's local column block, fed
an input through ``ModelSplit.copy_to``; ``dense_row`` is the row-parallel
one; ``embed_rows`` looks tokens up in a table split by vocabulary rows.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar

import torch
from torch import nn

__all__ = [
    "logical_axis_rules", "current_rules", "dtype_of", "dense", "dense_row",
    "embed_rows", "rmsnorm",
    "layernorm", "layernorm_np", "rope",
    "sinusoidal_positions", "trunc_normal", "Dense", "RMSNorm", "LayerNorm",
    "Embed", "dense_init", "embed_init", "param_tree", "draws",
    "reset_parameters",
]


_RULES: ContextVar[dict | None] = ContextVar("logical_axis_rules",
                                             default=None)


@contextmanager
def logical_axis_rules(rules: dict):
    """Bind logical-axis -> mesh-axis rules (e.g. {"batch": ("pod",
    "data"), "ff": "model"}) for the duration of the block."""
    token = _RULES.set(dict(rules))
    try:
        yield
    finally:
        _RULES.reset(token)


def current_rules() -> dict | None:
    return _RULES.get()


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16,
            "float8_e4m3fn": torch.float8_e4m3fn}[name]


# ---------------------------------------------------------------------------
# computation: plain functions over {"w": ..., "b": ...} dicts
# ---------------------------------------------------------------------------

def dense(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w (+ b)`` in ``compute_dtype`` (weights cast at the call unless
    they already are, as the LM's compute copies are)."""
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def dense_row(p, x: torch.Tensor, split, compute_dtype=torch.bfloat16
              ) -> torch.Tensor:
    """Row-parallel ``dense``: ``x`` holds this rank's block of the
    contraction dim and ``p["w"]`` the same block of rows; the partial
    products are summed over ``model`` (``split``, a
    ``models.distributed.ModelSplit``) and the bias, whole, added once."""
    y = split.reduce_from(x.to(compute_dtype) @ p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def embed_rows(w: torch.Tensor, tokens: torch.Tensor, split=None
               ) -> torch.Tensor:
    """``w[tokens]``. With ``split.vocab`` ``w`` is this rank's block of
    the table's rows: each rank looks up the tokens in its block, zeros
    for the others, and the lookups are summed over ``model`` (one term of
    each sum is not zero, so the sum is the row exactly)."""
    if split is None or not split.vocab:
        return w[tokens]
    n = w.shape[0]
    idx = tokens - split.block(n)
    mine = (idx >= 0) & (idx < n)
    rows = w[idx.clamp(0, n - 1)]
    return split.reduce_from(torch.where(
        mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                           device=rows.device)))


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parametric LayerNorm (musicgen, nemotron)."""
    y = layernorm_np(x, eps).float()
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, angles in float32. x: (..., S, H, hd); positions:
    (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs    # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Transformer sinusoidal embeddings (MusicGen-style)."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10_000.0) / max(half - 1, 1)))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# parameters: modules under the JAX keys, initialised from a Generator
# ---------------------------------------------------------------------------

def trunc_normal(shape, scale: float, generator: torch.Generator,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale`` x a normal truncated to [-2, 2], drawn in float32 (the JAX
    package's ``truncated_normal(-2, 2) * scale``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)


def draws(module: nn.Module, generator: torch.Generator, device):
    """``module``'s initial parameter values, drawn one leaf at a time on
    ``device``: ``(name under module, float32 value)`` in the order the
    generator is used. A module with a ``draws`` method gives its own (its
    leaves' distributions); any other its children's, in order. A consumer
    that keeps only what it needs of each value before asking for the next
    holds one whole leaf at a time (``train.sharded``)."""
    if hasattr(module, "draws"):
        yield from module.draws(generator, device)
        return
    for child_name, child in module.named_children():
        for name, value in draws(child, generator, device):
            yield f"{child_name}.{name}", value


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw ``module``'s parameters (``draws``) into them, on their
    device."""
    device = next(module.parameters()).device
    for name, value in draws(module, generator, device):
        module.get_parameter(name).copy_(value)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """``{"w": (d_in, d_out), "b": (d_out,)}``; truncated-normal fan-in init
    (``scale`` defaults to 1/sqrt(d_in)), zero bias."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 scale: float | None = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.init_scale = d_in ** -0.5 if scale is None else scale
        self.w = _param((d_in, d_out), dtype, device)
        if bias:
            self.b = _param((d_out,), dtype, device)

    def draws(self, generator: torch.Generator, device):
        yield "w", trunc_normal(self.w.shape, self.init_scale, generator,
                                device=device)
        if hasattr(self, "b"):
            yield "b", torch.zeros(self.b.shape, device=device)

    reset_parameters = reset_parameters


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = _param((d,), dtype, device)

    def draws(self, generator, device):
        yield "scale", torch.ones(self.scale.shape, device=device)

    reset_parameters = reset_parameters


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = _param((d,), dtype, device)
        self.bias = _param((d,), dtype, device)

    def draws(self, generator, device):
        yield "scale", torch.ones(self.scale.shape, device=device)
        yield "bias", torch.zeros(self.bias.shape, device=device)

    reset_parameters = reset_parameters


class Embed(nn.Module):
    """``{"w": (vocab, d)}``, normal x d^-0.5."""

    def __init__(self, vocab: int, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.w = _param((vocab, d), dtype, device)

    def draws(self, generator: torch.Generator, device):
        w = torch.empty(self.w.shape, dtype=torch.float32, device=device)
        w.normal_(generator=generator)
        yield "w", w * self.w.shape[1] ** -0.5

    reset_parameters = reset_parameters


def dense_init(generator, d_in: int, d_out: int, *, bias: bool = False,
               scale: float | None = None, dtype=torch.float32,
               device=None) -> Dense:
    layer = Dense(d_in, d_out, bias=bias, scale=scale, dtype=dtype,
                  device=device)
    with torch.no_grad():
        layer.reset_parameters(generator)
    return layer


def embed_init(generator, vocab: int, d: int, dtype=torch.float32,
               device=None) -> Embed:
    layer = Embed(vocab, d, dtype=dtype, device=device)
    with torch.no_grad():
        layer.reset_parameters(generator)
    return layer


def param_tree(module: nn.Module) -> dict:
    """The module's parameters as a nested dict under their names: the
    shape of the JAX package's parameter pytree."""
    tree: dict = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        tree[name] = param_tree(child)
    return tree
