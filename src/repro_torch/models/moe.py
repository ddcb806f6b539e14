"""Mixture-of-Experts layer with PSTS positional-scan dispatch.

Routing runs per token *group* (a sequence); all groups are dispatched at
once (``sched.moe_dispatch.dispatch_grouped``, the positions kernel taking
the groups as rows).

Data movement modes:
  * ``scatter`` (default): tokens gather into (E, C) slot buffers and back —
    no matmul FLOPs spent on dispatch;
  * ``einsum``: classic GShard dense (T, E, C) one-hot einsums — kept as the
    baseline.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..sched.moe_dispatch import dispatch_grouped, router_aux_loss
from .common import Dense, reset_parameters, trunc_normal
from .mlp import activation_fn

__all__ = ["MoE", "moe_init", "moe_apply", "moe_capacity"]


def moe_capacity(group_tokens: int, k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Per-expert slot count; a multiple of 8, as in the JAX package."""
    c = math.ceil(group_tokens * k * capacity_factor / n_experts)
    return max(8, -(-c // 8) * 8)


class MoE(nn.Module):
    """``{"router": {"w": (d, E)} in float32, "wi"/"wg": (E, d, ff), "wo":
    (E, ff, d)}``."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.scale_in = d ** -0.5
        self.scale_out = (ff * 2 * cfg.n_layers) ** -0.5
        self.router = Dense(d, e, dtype=torch.float32, device=device)

        def p(shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)
        self.wi = p((e, d, ff))
        self.wo = p((e, ff, d))
        if cfg.mlp_gated:
            self.wg = p((e, d, ff))

    def draws(self, generator: torch.Generator, device):
        for name, value in self.router.draws(generator, device):
            yield f"router.{name}", value
        for name, scale in (("wi", self.scale_in), ("wo", self.scale_out),
                            ("wg", self.scale_in)):
            if hasattr(self, name):
                yield name, trunc_normal(getattr(self, name).shape, scale,
                                         generator, device=device)

    reset_parameters = reset_parameters


def moe_init(generator, cfg, dtype=torch.float32, device=None) -> MoE:
    m = MoE(cfg, dtype=dtype, device=device)
    with torch.no_grad():
        m.reset_parameters(generator)
    return m


def _expert_ffn(p, xin, activation, compute_dtype):
    """xin: (G, E, C, d) -> (G, E, C, d); per-expert matmuls."""
    h = torch.einsum("gecd,edf->gecf", xin, p["wi"].to(compute_dtype))
    if "wg" in p:
        g = torch.einsum("gecd,edf->gecf", xin, p["wg"].to(compute_dtype))
        h = activation_fn(activation)(g) * h
    else:
        h = activation_fn(activation)(h)
    return torch.einsum("gecf,efd->gecd", h, p["wo"].to(compute_dtype))


def moe_apply(p, x, cfg, *, rebalance=None, mode: str = "scatter",
              batch=None):
    """x: (B, S, d) -> (y, aux). Routing group = one sequence. ``batch``
    (a ``models.distributed.BatchGroup``): x is this rank's rows of a batch
    split over ranks, and the aux loss is this rank's share of the whole
    batch's."""
    b, s, d = x.shape
    compute_dtype = x.dtype
    k = cfg.experts_per_token
    cap = moe_capacity(s, k, cfg.n_experts, cfg.capacity_factor)
    if rebalance is None:
        rebalance = cfg.psts_rebalance

    logits = x.float() @ p["router"]["w"]                 # router in f32
    aux_loss = router_aux_loss(logits, k, batch)
    res = dispatch_grouped(logits, k=k, capacity=cap, rebalance=rebalance,
                           position_method=cfg.dispatch_positions)

    if mode == "scatter":
        tok, valid = res.slot_to_token()                  # (G, E, C) each
        gidx = torch.arange(b, device=x.device)
        xin = x[gidx[:, None, None], tok.long()]          # (G, E, C, d)
        xin = xin * valid[..., None].to(compute_dtype)
        out = _expert_ffn(p, xin, cfg.activation, compute_dtype)
        # a dropped assignment's slot may lie beyond C: read any slot, its
        # weight is 0 (the JAX gather clamps the index the same way)
        y_slots = out[gidx[:, None, None], res.expert_idx.long(),
                      res.slot_idx.long().clamp(max=cap - 1)]  # (G, S, k, d)
        w = (res.weight * res.keep).to(compute_dtype)
        y = (y_slots * w[..., None]).sum(2)
    elif mode == "einsum":
        d_tensor, combine = res.dense(dtype=compute_dtype)
        xin = torch.einsum("gtec,gtd->gecd", d_tensor, x)
        out = _expert_ffn(p, xin, cfg.activation, compute_dtype)
        y = torch.einsum("gtec,gecd->gtd", combine, out)
    else:
        raise ValueError(f"unknown moe mode {mode!r}")

    aux = {"moe_aux_loss": aux_loss,
           "overflow": res.aux["overflow"].sum(),
           "rebalanced": res.aux["rebalanced"].sum(),
           "dropped": res.aux["dropped"].sum()}
    return y, aux
