"""Plain PyTorch versions of the hand-written kernels.

The CPU path of :mod:`repro_torch.kernels.ops` runs these, the CPU tests hold
them against the JAX package's Pallas kernels, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card. They repeat the kernels' arithmetic
in plain tensor code and are no yardstick of speed.
"""

from __future__ import annotations

import torch

__all__ = ["prefix_scan_ref", "dispatch_work_prefix_ref",
           "dispatch_positions_ref", "dispatch_positions_levels_ref",
           "check_lengths", "prefill_positions",
           "flash_attention_ref", "flash_attention_bwd_ref",
           "mamba_scan_ref", "mamba_scan_bwd_ref"]

_NEG = -2.0 ** 30  # the attention mask value, as in the JAX package


def prefix_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum along the last axis."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype) - x


def dispatch_work_prefix_ref(expert_idx: torch.Tensor, weights: torch.Tensor,
                             n_experts: int, init: torch.Tensor | None = None):
    """Per row: each destination's running sum of its tokens' weights, and
    the sum each token finds before its own.

    ``expert_idx`` (R, T) integer destinations (outside ``[0, n_experts)``,
    e.g. -1, means none), ``weights`` (R, T), ``init`` (R, E) the sums'
    starting values (0 if None). Returns ``(prefix (R, T), fill (R, E))``:
    ``prefix`` is ``init`` plus the weight of the EARLIER tokens with the
    same destination (0 for a token without one), ``fill`` is ``init`` plus
    all of them. Reference semantics, bit for bit: the ordered loop of
    ``runtime.vector_backend.simulate_scalar`` (``acc[e] += w`` in token
    order, as ``np.add.at`` adds), whose last bits the engine's branches
    see.

    Tokens are stably sorted by ``row * E + dest`` (index order kept within
    a destination); step k adds the k-th token of every destination's run
    at once, so the loop runs as many steps as the longest run, vectorized
    over destinations (E = 12,500 at full width).
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
    n_valid = int(valid.sum())
    order = order[:n_valid]          # the sentinel key r * e sorts last
    k_s = key[order]
    w_s = weights.reshape(-1)[order]
    acc = (torch.zeros(r * e, dtype=dt, device=dev) if init is None
           else init.to(dt).reshape(-1).clone())
    prefix = torch.zeros(r * t, dtype=dt, device=dev)
    if n_valid:
        at = torch.arange(n_valid, device=dev)
        first = torch.ones(n_valid, dtype=torch.bool, device=dev)
        first[1:] = k_s[1:] != k_s[:-1]
        rank = at - torch.cummax(torch.where(first, at, 0), dim=0).values
        by_rank = torch.argsort(rank, stable=True)
        done = 0
        for count in torch.bincount(rank).tolist():
            sel = by_rank[done:done + count]   # one token of each run
            done += count
            keys = k_s[sel]
            prefix[order[sel]] = acc[keys]
            acc[keys] = acc[keys] + w_s[sel]
    return prefix.reshape(r, t), acc.reshape(r, e)


def dispatch_positions_ref(expert_idx: torch.Tensor, base: torch.Tensor,
                           n_experts: int):
    """Per row: each token's exclusive position within its expert, counted
    from ``base`` prior fills, and the fills after the row.

    ``expert_idx`` (R, T) integer experts (outside ``[0, n_experts)``, e.g.
    -1, means none: position 0, counts nowhere), ``base`` (R, E). Returns
    ``(pos (R, T), fill (R, E))`` in int32, ``fill`` including ``base``.
    Row r is ``repro.kernels.ref.dispatch_positions_ref`` of row r: the
    one-hot exclusive cumsum, batched over rows.
    """
    e = int(n_experts)
    valid = (expert_idx >= 0) & (expert_idx < e)
    idx = torch.where(valid, expert_idx.long(), torch.zeros_like(
        expert_idx, dtype=torch.long))
    onehot = (torch.nn.functional.one_hot(idx, e).to(torch.int32)
              * valid.unsqueeze(-1))                      # (R, T, E)
    cum = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    base = base.to(torch.int32)
    pos = ((cum + base.unsqueeze(1)) * onehot).sum(-1, dtype=torch.int32)
    fill = base + onehot.sum(1, dtype=torch.int32)
    return pos, fill


def dispatch_positions_levels_ref(topk_idx: torch.Tensor, n_experts: int,
                                  capacity: int):
    """:func:`dispatch_positions_ref` over the k priority levels of
    ``topk_idx`` (R, T, k): level s counts from ``min(fill of level s - 1,
    capacity)``, 0 at level 0 (all first choices place before any second
    choice). Returns ``(slot_idx (R, T, k) int32, keep (R, T, k) bool,
    filled (R, E) int32)``: keep is ``slot_idx < capacity`` and ``filled``
    the last level's fill clamped to ``capacity`` (the kept count)."""
    r, _, k = topk_idx.shape
    filled = torch.zeros((r, n_experts), dtype=torch.int32,
                         device=topk_idx.device)
    slot_idx = []
    for s in range(k):
        pos, fill = dispatch_positions_ref(topk_idx[:, :, s], filled,
                                           n_experts)
        slot_idx.append(pos)
        filled = torch.clamp(fill, max=capacity)
    slot_idx = torch.stack(slot_idx, dim=2)
    return slot_idx, slot_idx < capacity, filled


def check_lengths(lengths: torch.Tensor, b: int, s: int, *,
                  values: bool = True) -> None:
    """Refuses prompt ``lengths`` unless they are (B,) integers, each in
    [1, S]; the values are read only with ``values`` (on a card tensor
    that costs a sync) and on a tensor that has them (not on meta)."""
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be (B,) = ({b},), got "
                         f"{tuple(lengths.shape)}")
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise TypeError(f"lengths must be integers, got {lengths.dtype}")
    if values and b and lengths.device.type != "meta" and not (
            1 <= int(lengths.min()) and int(lengths.max()) <= s):
        raise ValueError(f"every length must lie in [1, S = {s}], got "
                         f"{lengths.tolist()}")


def prefill_positions(lengths: torch.Tensor, s: int):
    """(q_positions, kv_positions) (B, S) int32 of right-padded prompts of
    ``lengths`` (B,) real tokens: ``kv_pos[b, j] = j`` for ``j < L_b``, -1
    beyond, and ``q_pos = max(kv_pos, 0)``, as the LM's prefill masks."""
    check_lengths(lengths, lengths.shape[0], s)
    pos = torch.arange(s, device=lengths.device).expand(lengths.shape[0], s)
    kv = torch.where(pos < lengths[:, None], pos, -1).to(torch.int32)
    return kv.clamp_min(0), kv


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                        q_positions=None, kv_positions=None, lengths=None):
    """Full-materialisation attention, in float32, output in ``q.dtype``.

    q (B, H, S, hd); k, v (B, KV, S, hd) with H % KV == 0 (query head h
    reads KV head h // (H // KV)). Without positions this is
    ``repro.kernels.ref.flash_attention_ref``: the mask is by index (causal
    ``i >= j``, window ``i - j < window``). With ``q_positions`` (B, S) and
    ``kv_positions`` (B, S) int it is the model's mask
    (``repro.models.attention.chunked_attention``): key j is seen by query i
    iff ``kv_pos[j] >= 0`` and, causal, ``q_pos[i] >= kv_pos[j]`` and, with a
    window, ``q_pos[i] - kv_pos[j] < window``. Masked logits are -2**30.
    ``lengths`` (B,) in place of the positions is the flash kernels' length
    form, the positions of :func:`prefill_positions`.
    """
    b, h, s, hd = q.shape
    rep = h // k.shape[1]
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) * hd ** -0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if lengths is not None:
        if q_positions is not None or kv_positions is not None:
            raise ValueError("give lengths or positions, not both")
        check_lengths(lengths, b, s, values=False)
        q_positions, kv_positions = prefill_positions(lengths, s)
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("give both q_positions and kv_positions, or neither")
    if q_positions is None:
        idx = torch.arange(s, device=q.device)
        q_pos, kv_pos = idx.expand(b, s), idx.expand(b, s)
    else:
        q_pos, kv_pos = q_positions, kv_positions
    qp = q_pos[:, None, :, None]
    kp = kv_pos[:, None, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (qp >= kp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    logits = torch.where(mask, logits, torch.full((), _NEG,
                                                  device=q.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, vf).to(q.dtype)


def mamba_scan_ref(da: torch.Tensor, dbx: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """The selective-scan recurrence ``h_t = da_t * h_{t-1} + dbx_t`` over
    axis 1, from ``h0`` (B, N, di) or zero, in float32.

    da, dbx (B, S, N, di) of any float type (the layout of
    ``repro.kernels.ref.mamba_scan_ref``); returns h (B, S, N, di) float32.
    A sequential loop over S, in the kernel's order: padding steps with
    da = 1 and dbx = 0 carry the state unchanged.
    """
    da32, dbx32 = da.float(), dbx.float()
    b, s, n, di = da.shape
    out = torch.empty((b, s, n, di), dtype=torch.float32, device=da.device)
    h = (torch.zeros((b, n, di), dtype=torch.float32, device=da.device)
         if h0 is None else h0.float())
    for t in range(s):
        h = torch.addcmul(dbx32[:, t], da32[:, t], h)
        out[:, t] = h
    return out


def flash_attention_bwd_ref(q, k, v, dout, *, causal=True, window=None,
                            softcap=None):
    """(dq, dk, dv) of :func:`flash_attention_ref`'s index form at q, k, v
    for the output gradient ``dout``, by autograd through the full
    softmax; each in its input's type."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, window=window,
                                  softcap=softcap)
        return torch.autograd.grad(out, leaves, dout)


def mamba_scan_bwd_ref(da: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """(dL/dda, dL/ddbx) float32 of ``h = mamba_scan_ref(da, dbx)`` (from h
    = 0) given ``g = dL/dh``, all (B, S, N, di): the reverse loop
    ``gh_t = g_t + da_{t+1} gh_{t+1}``, ``dL/ddbx_t = gh_t``, ``dL/dda_t =
    gh_t h_{t-1}`` with ``h_{-1} = 0``, in the kernel's order."""
    da32, h32, g32 = da.float(), h.float(), g.float()
    gda = torch.empty_like(g32)
    gdbx = torch.empty_like(g32)
    carry = torch.zeros_like(g32[:, 0])
    for t in range(da.shape[1] - 1, -1, -1):
        gh = g32[:, t] + carry
        gdbx[:, t] = gh
        gda[:, t] = gh * h32[:, t - 1] if t else 0.0
        carry = da32[:, t] * gh
    return gda, gdbx
