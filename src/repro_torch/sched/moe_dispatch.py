"""PSTS token -> expert dispatch — the paper's positional-scan balancing
applied per MoE layer.

Mapping onto the paper:
  tokens  = indivisible tasks (beta = 1 work unit),
  experts = nodes; capacity C_e = power tau_e,
  router top-k choice = the task's initial placement,
  per-expert exclusive position scan = the paper's load scan ``S``,
  overflow re-route = the sender/receiver migration: overflow tokens form an
  ordered stream that is carved into the *free-capacity intervals* of
  under-loaded experts by exclusive scans (``owner_of_fraction`` in integer
  form) — instead of being dropped, as plain capacity routing does.

The computation is batched over token groups (the JAX package vmaps over
them): every tensor has a leading group axis G. The ``scan`` position method
runs the expert-dispatch positions kernel
(``kernels.ops.dispatch_positions_levels``) once per layer over all priority
slots and all groups at once, the groups being its rows; ``sort`` is the
equivalent stable-sort form. Nothing here reads a value back
to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import ops

__all__ = ["DispatchResult", "dispatch", "dispatch_grouped",
           "router_aux_loss"]


@dataclass
class DispatchResult:
    """Slot assignment for one token group (fields (T, k)) or for G groups
    (fields (G, T, k)).

    expert_idx: destination expert per token-slot (int32).
    slot_idx:   position within the expert's capacity buffer (int32).
    keep:       bool — assignment survived (not dropped).
    weight:     combine weight (normalised router prob, float32).
    capacity:   C.
    aux:        overflow/rebalanced/dropped counts and load stats (per
                group where grouped).
    """

    expert_idx: torch.Tensor
    slot_idx: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    capacity: int
    n_experts: int
    aux: dict

    def slot_to_token(self):
        """(..., E, C) token index feeding each expert slot + (..., E, C)
        validity."""
        grouped = self.expert_idx.dim() == 3
        e_idx, s_idx, keep = (self.expert_idx, self.slot_idx, self.keep)
        if not grouped:
            e_idx, s_idx, keep = e_idx[None], s_idx[None], keep[None]
        g, t_len, k = e_idx.shape
        e, c = self.n_experts, self.capacity
        dev = e_idx.device
        flat_tok = torch.arange(t_len, dtype=torch.int32, device=dev)
        flat_tok = flat_tok[:, None].expand(t_len, k).reshape(1, -1)
        flat_tok = flat_tok.expand(g, -1)
        keep_flat = keep.reshape(g, -1)
        # dropped assignments land in a spare row E, cut off below
        e_safe = torch.where(keep_flat, e_idx.reshape(g, -1).long(), e)
        s_safe = torch.where(keep_flat, s_idx.reshape(g, -1).long(), 0)
        flat = e_safe * c + s_safe
        tok = torch.zeros((g, (e + 1) * c), dtype=torch.int32, device=dev)
        tok.scatter_(1, flat, flat_tok)
        valid = torch.zeros((g, (e + 1) * c), dtype=torch.bool, device=dev)
        valid.scatter_(1, flat, keep_flat)
        tok = tok.reshape(g, e + 1, c)[:, :e]
        valid = valid.reshape(g, e + 1, c)[:, :e]
        return (tok, valid) if grouped else (tok[0], valid[0])

    def dense(self, dtype=torch.float32):
        """GShard-style (..., T, E, C) dispatch/combine tensors."""
        e_oh = torch.nn.functional.one_hot(self.expert_idx.long(),
                                           self.n_experts).to(dtype)
        # an out-of-range slot (a dropped assignment) has an all-zero row
        c_oh = (self.slot_idx[..., None] == torch.arange(
            self.capacity, device=self.slot_idx.device)).to(dtype)
        mask = self.keep.to(dtype)[..., None]
        w = (self.weight * self.keep).to(dtype)[..., None]
        d_tensor = torch.einsum("...tke,...tkc->...tec", e_oh * mask, c_oh)
        combine = torch.einsum("...tke,...tkc->...tec", e_oh * w, c_oh)
        return d_tensor, combine


def _positions_scan(topk_idx: torch.Tensor, n_exp: int, capacity: int):
    """Slot-priority positions via the per-expert exclusive scans — the
    paper's formulation: one ``ops.dispatch_positions_levels`` call for all
    priority slots (all first choices place before any second choice), rows
    = groups. Slot s counts from the previous slot's fill clamped to C, so
    ``filled`` (the kept count) never exceeds C."""
    return ops.dispatch_positions_levels(topk_idx.contiguous(), n_exp,
                                         capacity)


def _positions_sort(topk_idx: torch.Tensor, n_exp: int, capacity: int):
    """Identical positions via one stable sort over (k*T) keys per group.
    Slot-major key order reproduces the slot-priority semantics exactly:
    within an expert, all slot-0 tokens place before any slot-1 token, in
    token order."""
    g, t_len, k = topk_idx.shape
    kt = t_len * k
    dev = topk_idx.device
    e_flat = topk_idx.transpose(1, 2).reshape(g, kt).long()  # slot-major
    ar = torch.arange(kt, device=dev)
    keys = e_flat * kt + ar
    order = torch.argsort(keys, dim=1, stable=True)
    sorted_e = torch.gather(e_flat, 1, order).contiguous()
    experts = torch.arange(n_exp, device=dev).expand(g, n_exp).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts)
    pos_sorted = ar - torch.gather(seg_start, 1, sorted_e)
    pos_flat = torch.zeros_like(pos_sorted).scatter_(1, order, pos_sorted)
    slot_idx = pos_flat.reshape(g, k, t_len).transpose(1, 2)
    slot_idx = slot_idx.to(torch.int32)
    keep = slot_idx < capacity
    counts = torch.searchsorted(sorted_e, experts, right=True) - seg_start
    filled = torch.clamp(counts, max=capacity).to(torch.int32)
    return slot_idx, keep, filled


def _dispatch(router_logits: torch.Tensor, k: int, capacity: int,
              rebalance: bool, position_method: str) -> DispatchResult:
    """Dispatch of G groups at once: router_logits (G, T, E)."""
    g, t_len, n_exp = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    topk_idx = torch.topk(router_logits, k, dim=-1, sorted=True).indices
    topk_idx = topk_idx.to(torch.int32)                   # (G, T, k)

    fn = {"scan": _positions_scan, "sort": _positions_sort}[position_method]
    slot_idx, keep, filled = fn(topk_idx, n_exp, capacity)
    expert_idx = topk_idx
    weight = torch.gather(probs, 2, topk_idx.long())      # (G, T, k)
    n_overflow = (~keep).sum((1, 2))

    n_rebalanced = torch.zeros(g, dtype=torch.int64, device=probs.device)
    if rebalance:
        # ---- the paper's sender/receiver pass -----------------------------
        # overflow token-slots, ordered token-major (the scan order)
        over = (~keep).reshape(g, -1)                     # (G, T*k)
        over_pos = torch.cumsum(over, dim=1) - over.long()  # stream index
        filled = filled.long()
        free = capacity - filled                          # receiver deficit
        gstart = torch.cumsum(free, dim=1) - free         # interval starts
        total_free = free.sum(1, keepdim=True)
        # receiver owning stream position o (zero-free experts own empty
        # intervals — searchsorted(right) - 1 skips them, exactly
        # core.pslb.owner_of_fraction in integer form)
        dest = torch.searchsorted(gstart.contiguous(), over_pos.contiguous(),
                                  right=True) - 1
        dest = dest.clamp(0, n_exp - 1)
        valid = over & (over_pos < total_free)
        slot_new = (over_pos - torch.gather(gstart, 1, dest)
                    + torch.gather(filled, 1, dest))
        dest2d = dest.reshape(g, t_len, k)
        slot2d = slot_new.reshape(g, t_len, k).to(torch.int32)
        valid2d = valid.reshape(g, t_len, k)
        # re-routed weight = router affinity for the actual destination
        w_new = torch.gather(probs, 2, dest2d)
        expert_idx = torch.where(valid2d, dest2d.to(torch.int32), expert_idx)
        slot_idx = torch.where(valid2d, slot2d, slot_idx)
        weight = torch.where(valid2d, w_new, weight)
        keep = keep | valid2d
        n_rebalanced = valid.sum(1)

    # normalise combine weights over the token's surviving assignments
    weight = weight * keep
    denom = weight.sum(2, keepdim=True)
    weight = torch.where(denom > 0, weight / denom.clamp_min(1e-9),
                         torch.zeros((), device=weight.device))

    load = torch.nn.functional.one_hot(topk_idx[:, :, 0].long(),
                                       n_exp).float().mean(1)
    aux = {
        "overflow": n_overflow,
        "rebalanced": n_rebalanced,
        "dropped": (~keep).sum((1, 2)),
        "top1_load": load,
        "mean_prob": probs.mean(1),
    }
    return DispatchResult(expert_idx, slot_idx, keep, weight, capacity,
                          n_exp, aux)


def dispatch(router_logits: torch.Tensor, k: int, capacity: int,
             rebalance: bool = True,
             position_method: str = "scan") -> DispatchResult:
    """Capacity-limited top-k dispatch of one token group, router_logits
    (T, E), with optional PSTS overflow re-route.

    position_method: "scan" (the paper's per-expert scans, the dispatch
    positions kernel) or "sort" (equivalent positions by a stable sort).
    """
    res = _dispatch(router_logits[None], k, capacity, rebalance,
                    position_method)
    return DispatchResult(res.expert_idx[0], res.slot_idx[0], res.keep[0],
                          res.weight[0], capacity, res.n_experts,
                          {name: v[0] for name, v in res.aux.items()})


def dispatch_grouped(router_logits: torch.Tensor, k: int, capacity: int,
                     rebalance: bool = True,
                     position_method: str = "scan") -> DispatchResult:
    """:func:`dispatch` of every token group at once: router_logits (G, g,
    E); the result's fields and aux carry the group axis."""
    return _dispatch(router_logits, k, capacity, rebalance, position_method)


def router_aux_loss(router_logits: torch.Tensor, k: int,
                    batch=None) -> torch.Tensor:
    """Switch/GShard load-balancing loss: E * sum_e f_e * p_e  (+ z-loss).

    With ``batch`` (a ``models.distributed.BatchGroup`` of R > 1 ranks,
    each holding as many tokens) the logits are this rank's rows of the
    batch: f is the whole batch's (summed over the ranks, no gradient) and
    the result this rank's share, (E * sum_e f_e * p_e + 1e-3 * z) / R over
    its own p and z, so the shares sum to the whole batch's loss."""
    logits = router_logits.float()
    n_exp = logits.shape[-1]
    flat = torch.softmax(logits, dim=-1).reshape(-1, n_exp)
    topk_idx = torch.topk(flat, k, dim=-1).indices
    f = torch.nn.functional.one_hot(topk_idx, n_exp).float().sum(1).mean(0)
    p = flat.mean(0)
    if batch is not None and batch.ranks > 1:
        f = batch.sum_(f) / batch.ranks
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        return (n_exp * torch.sum(f * p) + 1e-3 * z) / batch.ranks
    balance = n_exp * torch.sum(f * p)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return balance + 1e-3 * z
