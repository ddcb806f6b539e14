"""Plain PyTorch versions of the hand-written kernels.

The CPU path of :mod:`repro_torch.kernels.ops` runs these, the CPU tests hold
them against the JAX package's Pallas kernels, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card. They repeat the kernels' arithmetic
in plain tensor code and are no yardstick of speed.
"""

from __future__ import annotations

import torch

__all__ = ["prefix_scan_ref", "dispatch_work_prefix_ref"]


def prefix_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum along the last axis."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype) - x


def dispatch_work_prefix_ref(expert_idx: torch.Tensor, weights: torch.Tensor,
                             n_experts: int):
    """Per row: the summed weight of EARLIER tokens with the same
    destination, and the per-destination totals.

    ``expert_idx`` (R, T) integer destinations (outside ``[0, n_experts)``,
    e.g. -1, means none), ``weights`` (R, T). Returns ``(prefix (R, T),
    fill (R, E))``. Reference semantics: the scalar loop of
    ``runtime.vector_backend.simulate_scalar``.

    Sort-by-destination segmented scan, so it scales to E = 12,500 where a
    one-hot would not: tokens are stably sorted by ``row * E + dest`` (index
    order kept within a destination), each destination's run is scanned by
    Hillis-Steele doubling (log2 of the longest run steps, no cancellation
    against a running row total), and the results scatter back.
    """
    r, t = expert_idx.shape
    e = int(n_experts)
    dev, dt = weights.device, weights.dtype
    valid = (expert_idx >= 0) & (expert_idx < e)
    rows = torch.arange(r, device=dev).unsqueeze(1)
    key = torch.where(valid, rows * e + expert_idx.long(),
                      torch.full_like(expert_idx, r * e, dtype=torch.long))
    key = key.reshape(-1)
    order = torch.argsort(key, stable=True)
    k_s = key[order]
    w_s = torch.where(valid, weights, torch.zeros_like(weights)).reshape(-1)
    w_s = w_s[order]
    inc = w_s.clone()
    shift = 1
    n = inc.numel()
    while shift < n:
        same = k_s[shift:] == k_s[:-shift]
        if not bool(same.any()):
            break
        inc = torch.cat([inc[:shift],
                         inc[shift:] + torch.where(same, inc[:-shift],
                                                   torch.zeros((), dtype=dt,
                                                               device=dev))])
        shift *= 2
    # exclusive = the inclusive value of the previous token of the same run
    exc = torch.zeros_like(inc)
    if n > 1:
        exc[1:] = torch.where(k_s[1:] == k_s[:-1], inc[:-1],
                              torch.zeros((), dtype=dt, device=dev))
    prefix = torch.empty_like(exc)
    prefix[order] = exc
    prefix = torch.where(valid, prefix.reshape(r, t), torch.zeros((), dtype=dt,
                                                                 device=dev))
    fill = torch.zeros(r * e + 1, dtype=dt, device=dev)
    if n:
        last = torch.ones(n, dtype=torch.bool, device=dev)
        last[:-1] = k_s[1:] != k_s[:-1]
        fill[k_s[last]] = inc[last]
    return prefix, fill[:r * e].reshape(r, e)
