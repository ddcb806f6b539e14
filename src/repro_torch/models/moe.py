"""Mixture-of-Experts layer with PSTS positional-scan dispatch.

Routing runs per token *group* (a sequence); all groups are dispatched at
once (``sched.moe_dispatch.dispatch_grouped``, the positions kernel taking
the groups as rows).

Data movement modes:
  * ``scatter`` (default): tokens gather into (E, C) slot buffers and back —
    no matmul FLOPs spent on dispatch;
  * ``einsum``: classic GShard dense (T, E, C) one-hot einsums — kept as the
    baseline.

Under a split over ``model`` (``moe_apply``'s ``split``, a
``models.distributed.ModelSplit``) routing and dispatch stay replicated,
so the positions kernel still sees every token of the rank's rows, and the
aux loss and counters are the whole layer's. With ``experts`` a rank runs
its E/m experts' slots only; with ``moe_ff`` (the legacy layout) every
expert on its ff columns. Either way its combine is a partial sum,
all-reduced over ``model``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..sched.moe_dispatch import dispatch_grouped, router_aux_loss
from .common import Dense, reset_parameters, trunc_normal
from .distributed import LOCAL
from .mlp import activation_fn

__all__ = ["MoE", "moe_init", "moe_apply", "moe_capacity", "split_modes"]


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
              batch=None, split=None):
    """x: (B, S, d) -> (y, aux). Routing group = one sequence. ``batch``
    (a ``models.distributed.BatchGroup``): x is this rank's rows of a batch
    split over ranks, and the aux loss is this rank's share of the whole
    batch's. ``split``: the weights are this rank's experts or ff columns
    (module docstring)."""
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

    tp = split is not None and (split.experts or split.moe_ff)
    # the experts this rank runs: [lo, lo + n)
    n = p["wi"].shape[0]
    lo = split.block(n) if tp and split.experts else 0
    xs = split.copy_to(x) if tp else x
    if mode == "scatter":
        tok, valid = res.slot_to_token()                  # (G, E, C) each
        gidx = torch.arange(b, device=x.device)
        xin = xs[gidx[:, None, None], tok[:, lo:lo + n].long()]
        xin = xin * valid[:, lo:lo + n, :, None].to(compute_dtype)
        out = _expert_ffn(p, xin, cfg.activation, compute_dtype)
        # a dropped assignment's slot may lie beyond C: read any slot, its
        # weight is 0 (the JAX gather clamps the index the same way)
        e = res.expert_idx.long()
        w = (res.weight * res.keep).to(compute_dtype)
        if tp:
            w = split.copy_to(w)
        if tp and split.experts:            # other ranks' experts weigh 0
            e = e - lo
            w = torch.where((e >= 0) & (e < n), w,
                            torch.zeros((), dtype=w.dtype, device=w.device))
            e = e.clamp(0, n - 1)
        y_slots = out[gidx[:, None, None], e,
                      res.slot_idx.long().clamp(max=cap - 1)]  # (G, S, k, d)
        y = (y_slots * w[..., None]).sum(2)
    elif mode == "einsum":
        d_tensor, combine = res.dense(dtype=compute_dtype)
        if tp:      # before the cut: the gradient's parts sum over ranks
            combine = split.copy_to(combine)
        d_tensor, combine = d_tensor[:, :, lo:lo + n], combine[:, :, lo:lo + n]
        xin = torch.einsum("gtec,gtd->gecd", d_tensor, xs)
        out = _expert_ffn(p, xin, cfg.activation, compute_dtype)
        y = torch.einsum("gtec,gecd->gtd", combine, out)
    else:
        raise ValueError(f"unknown moe mode {mode!r}")
    if tp:
        y = split.reduce_from(y)

    aux = {"moe_aux_loss": aux_loss,
           "overflow": res.aux["overflow"].sum(),
           "rebalanced": res.aux["rebalanced"].sum(),
           "dropped": res.aux["dropped"].sum()}
    return y, aux


def split_modes(split) -> dict:
    """How the split uses each weight (``models.distributed``): the
    experts' weights keep their shards of the rank's experts or ff
    columns; the router is whole."""
    if not (split.experts or split.moe_ff):
        return {}
    return dict.fromkeys(("wi", "wg", "wo"), LOCAL)
