"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain, with silu / gelu /
squared-ReLU (nemotron) activations."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, dense, reset_parameters

__all__ = ["MLP", "mlp_init", "mlp_apply", "activation_fn"]


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron-4: squared ReLU
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


class MLP(nn.Module):
    """``{"wi", "wo", "wg"?}`` dense layers."""

    def __init__(self, d: int, ff: int, *, gated: bool, n_layers: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.wi = Dense(d, ff, dtype=dtype, device=device)
        self.wo = Dense(ff, d, scale=(ff * 2 * n_layers) ** -0.5,
                        dtype=dtype, device=device)
        if gated:
            self.wg = Dense(d, ff, dtype=dtype, device=device)

    reset_parameters = reset_parameters


def mlp_init(generator, d: int, ff: int, *, gated: bool, n_layers: int,
             dtype=torch.float32, device=None) -> MLP:
    m = MLP(d, ff, gated=gated, n_layers=n_layers, dtype=dtype,
            device=device)
    with torch.no_grad():
        m.reset_parameters(generator)
    return m


def mlp_apply(p, x: torch.Tensor, *, activation: str) -> torch.Tensor:
    act = activation_fn(activation)
    h = dense(p["wi"], x, x.dtype)
    if "wg" in p:
        h = act(dense(p["wg"], x, x.dtype)) * h
    else:
        h = act(h)
    return dense(p["wo"], h, x.dtype)
