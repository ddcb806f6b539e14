"""Vectorized batched-scenario backend: hundreds of runtime seeds in one
batched run on the GPU.

Parameter sweeps (cluster size, arrival rate, trigger constants, failure
patterns) need many scenario seeds; looping the event engine in Python is the
bottleneck. This backend runs B scenarios as one batched time-sliced
simulation on the device:

* time advances in fixed ``dt`` slots; each node drains ``tau_i * dt`` work
  units per slot (fluid FIFO service),
* arrivals are placed by the paper's positional rule over deficit intervals —
  the per-slot arrival stream's work positions come from ONE batched
  exclusive prefix scan over all tasks (``kernels.prefix_scan``, the paper's
  core operator), sliced per slot inside the loop,
* an optional crossover trigger fires per scenario and slot exactly as in
  ``core.trigger``: imbalance above max(crossover, floor) redistributes
  queued work to fair shares and books the migrated volume.

``simulate_scalar`` is the numpy reference with identical semantics and
operation order; ``simulate_batch`` must match it per seed to float tolerance
(tested), which pins the backend's meaning to something checkable. This is
the PyTorch port of ``repro.runtime.vector_backend``: the same float64
arithmetic in the same order, with the JAX ``lax.scan`` over slots written as
a Python loop over slots.

Determinism. The engine's discrete branches (the owner ``searchsorted``, the
trigger's ``imb > max(cross, floor)``) can flip on one bit, so every
float64 sum whose order could change from run to run on the card goes
through a hand-written kernel with a fixed order instead of an atomic
scatter-add or ``torch.cumsum`` (both run-to-run nondeterministic on CUDA
floats): the per-slot totals and the per-slot queue increments are the
dispatch kernel's ``fill`` (a serial per-destination sum in task order), and
the power prefix ``lam`` is the scan kernel. The remaining scatter-add sums
whole counts, which float64 holds exactly in any order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .metrics import nearest_rank
from .workload import batch_slots

__all__ = ["VectorConfig", "BatchMetrics", "simulate_batch",
           "simulate_scalar", "sweep_seeds", "to_tensors"]

_TINY = 1e-12


@dataclass(frozen=True)
class VectorConfig:
    """Static scenario parameters. Field for field the JAX package's
    ``VectorConfig``, so a test can rebuild one from the other's
    ``dataclasses.asdict``."""

    n_nodes: int
    n_slots: int
    dt: float = 1.0
    rebalance: bool = True          # crossover-trigger redistribution
    floor: float = 0.1              # trigger hysteresis floor
    p: float = 1e-3                 # comm step cost
    q: float = 1e-4                 # scan-add step cost
    t_task: float = 1e-4            # per-task placement cost
    packets_per_step: float = 64.0
    packets_per_unit: float = 2.0   # migration packets per work unit
    # FIFO-refined dispatch responses: a task's response also counts the
    # work of earlier same-slot arrivals routed to the same node (its own
    # dispatch wave's backlog), computed by the dispatch kernel
    # (``kernels.psts_dispatch``). Off by default — the plain fluid
    # response ignores intra-slot ordering entirely
    fifo_dispatch: bool = False
    # telemetry: emit per-slot probe series (queue snapshot, imbalance,
    # crossover, fire flag); off, the engine keeps none of them
    probe: bool = False

    @property
    def scan_steps(self) -> int:
        """1-D grid step count 2(n-1) (paper eq. 11) for the overhead term."""
        return 2 * (self.n_nodes - 1)


@dataclass(frozen=True)
class BatchMetrics:
    """Per-scenario metrics, shape (B,)."""

    mean_response: np.ndarray
    p99_response: np.ndarray
    makespan: np.ndarray
    trigger_fires: np.ndarray
    moved_units: np.ndarray
    completed: np.ndarray
    # probe series (cfg.probe only, else None): sampled once per slot at
    # the backlog point — after arrivals and the trigger's redistribution,
    # before service. Imbalance/crossover are the values the trigger
    # evaluated (pre-redistribution); an idle slot reads imbalance -1
    probe_queue: np.ndarray | None = None       # (B, T, n)
    probe_imbalance: np.ndarray | None = None   # (B, T)
    probe_crossover: np.ndarray | None = None   # (B, T)
    probe_fires: np.ndarray | None = None       # (B, T) bool


# ---------------------------------------------------------------------------
# Shared precomputation (identical formulas in both backends)
# ---------------------------------------------------------------------------

def _slot_tables_np(slot, works, n_slots):
    """Per-slot stream base (global-scan value at the slot's first task) and
    per-slot work totals / task counts. ``slot == n_slots`` marks padding."""
    S = np.cumsum(works) - works  # exclusive work scan (scan order = index)
    valid = slot < n_slots
    base = np.full(n_slots, np.inf)
    np.minimum.at(base, slot[valid], S[valid])
    tot = np.zeros(n_slots)
    np.add.at(tot, slot[valid], works[valid])
    cnt = np.zeros(n_slots)
    np.add.at(cnt, slot[valid], np.ones(valid.sum()))
    return S, np.where(np.isfinite(base), base, 0.0), tot, cnt


# ---------------------------------------------------------------------------
# Scalar reference engine (numpy, one scenario)
# ---------------------------------------------------------------------------

def simulate_scalar(slot: np.ndarray, works: np.ndarray, powers: np.ndarray,
                    cfg: VectorConfig,
                    power_scale: np.ndarray | None = None) -> dict:
    """One scenario with the exact semantics of ``simulate_batch``.

    ``slot``: (M,) arrival slot per task (``n_slots`` = padding sentinel);
    ``works``: (M,) work units; ``powers``: (n,) node powers;
    ``power_scale``: optional (T, n) multiplier (0 = node down that slot).
    """
    slot = np.asarray(slot)
    works = np.asarray(works, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    T, n = cfg.n_slots, cfg.n_nodes
    scale = (np.ones((T, n)) if power_scale is None
             else np.asarray(power_scale, dtype=np.float64))
    S, base, tot, cnt = _slot_tables_np(slot, works, T)

    queue = np.zeros(n)
    resp = np.zeros(works.shape[0])
    fires, moved, seen = 0, 0.0, 0.0
    backlog = np.zeros(T)
    probe_q = np.zeros((T, n)) if cfg.probe else None
    probe_imb = np.zeros(T) if cfg.probe else None
    probe_cross = np.zeros(T) if cfg.probe else None
    probe_fire = np.zeros(T, dtype=bool) if cfg.probe else None
    for t in range(T):
        mask = slot == t
        pw = powers * scale[t]
        pi = pw.sum()
        # -- arrivals: positional rule over deficit intervals
        if tot[t] > 0.0:
            fair = pw / pi * (queue.sum() + tot[t])
            deficit = np.maximum(fair - queue, 0.0)
            ds = deficit.sum()
            src, norm = (deficit, ds) if ds > 0.0 else (pw, pi)
            lam = np.cumsum(src / norm) - src / norm
            frac = np.clip((S - base[t] + 0.5 * works) / tot[t],
                           0.0, 1.0 - _TINY)
            owner = np.searchsorted(lam, frac, side="right") - 1
            backlog_ahead = 0.0
            if cfg.fifo_dispatch:
                # exclusive same-owner work prefix within the slot (the
                # FIFO backlog this dispatch wave builds in front of each
                # task) — reference semantics for the dispatch kernel
                # the batched path uses
                backlog_ahead = np.zeros(works.shape[0])
                acc = np.zeros(n)
                for i in np.flatnonzero(mask):
                    backlog_ahead[i] = acc[owner[i]]
                    acc[owner[i]] += works[i]
            resp = resp + np.where(mask,
                                   (queue[owner] + backlog_ahead + works) /
                                   np.maximum(pw[owner], _TINY), 0.0)
            np.add.at(queue, owner[mask], works[mask])
            seen += cnt[t]
        # -- crossover trigger (fluid redistribution of queued work); the
        # probe reads the same formulas, so the trigger signal it exports
        # is exactly what the decision saw (the guarded max(., _TINY)
        # denominators are identical to the old t_bal > _TINY branch
        # whenever that branch ran)
        if cfg.rebalance or cfg.probe:
            w = queue.sum()
            t_bal = w / pi if pi > 0.0 else 0.0
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(pw > 0.0, queue / np.maximum(pw, _TINY),
                                 np.where(queue > _TINY, np.inf, 0.0))
            imb = ratio.max() / max(t_bal, _TINY) - 1.0
            fair_q = pw / max(pi, _TINY) * w
            excess = np.maximum(queue - fair_q, 0.0).sum()
            overhead = (cfg.scan_steps * (cfg.p + cfg.q)
                        + seen / n * cfg.t_task
                        + excess * cfg.packets_per_unit
                        / cfg.packets_per_step * cfg.p)
            cross = overhead / max(t_bal, _TINY)
            fire = (cfg.rebalance and t_bal > _TINY
                    and imb > max(cross, cfg.floor))
            if fire:
                queue = fair_q
                moved += excess
                fires += 1
            if cfg.probe:
                probe_q[t] = queue
                probe_imb[t] = imb
                probe_cross[t] = cross
                probe_fire[t] = fire
        # -- service (backlog sampled before draining, so a slot that both
        # receives and finishes work still counts as busy)
        backlog[t] = queue.sum()
        queue = np.maximum(queue - pw * cfg.dt, 0.0)

    count = float(cnt.sum())
    drained = np.flatnonzero(backlog > _TINY)
    valid = slot < T
    out = {
        "mean_response": float(resp.sum() / count) if count else float("nan"),
        "p99_response": nearest_rank(resp[valid], 99.0),
        "makespan": float((drained[-1] + 1) * cfg.dt) if drained.size else 0.0,
        "trigger_fires": float(fires),
        "moved_units": float(moved),
        "completed": count,
    }
    if cfg.probe:
        out.update(probe_queue=probe_q, probe_imbalance=probe_imb,
                   probe_crossover=probe_cross, probe_fires=probe_fire)
    return out


# ---------------------------------------------------------------------------
# Batched PyTorch engine
# ---------------------------------------------------------------------------

def to_tensors(slot, works, powers, power_scale, *, device):
    """The engine's tensors from the numpy arrays a workload lowers to (what
    ``BatchedBackend.compile`` returns, in either package): ``slot`` (B, M)
    int32, ``works`` (B, M) float64, ``powers`` (n,) or (B, n) float64 —
    broadcast to (B, n) — and ``power_scale`` (T, n) float64 or ``None``."""
    device = torch.device(device)
    slot = torch.as_tensor(np.ascontiguousarray(slot, dtype=np.int32),
                           device=device)
    works = torch.as_tensor(np.ascontiguousarray(works, dtype=np.float64),
                            device=device)
    powers = torch.as_tensor(np.ascontiguousarray(powers, dtype=np.float64),
                             device=device)
    if powers.dim() == 1:
        powers = powers.expand(works.shape[0], -1).contiguous()
    scale = (None if power_scale is None else
             torch.as_tensor(np.ascontiguousarray(power_scale,
                                                  dtype=np.float64),
                             device=device))
    return slot, works, powers, scale


def _simulate_batch_torch(slot, works, powers, scale, cfg: VectorConfig):
    """The batched engine on tensors of one device; operation order as in
    the JAX package's ``_simulate_batch_jax``. Returns a tuple of tensors:
    ``(mean, p99, makespan, fires, moved, count)`` and, with ``cfg.probe``,
    ``(probe_queue, probe_imbalance, probe_crossover, probe_fires)``."""
    B, M = works.shape
    T, n = cfg.n_slots, cfg.n_nodes
    dev = works.device
    f64 = dict(dtype=torch.float64, device=dev)
    if scale is None:
        scale = torch.ones((T, n), **f64)
    inf = torch.tensor(float("inf"), **f64)
    zero = torch.zeros((), **f64)

    # one batched exclusive work scan over all tasks — the paper's core
    # operator, computed by the scan kernel
    S = ops.prefix_scan(works)
    valid = slot < T
    # the padding sentinel slot == T lands in an extra column, cut off (the
    # JAX scatter's mode="drop")
    col = slot.long()
    base = torch.full((B, T + 1), float("inf"), **f64).scatter_reduce_(
        1, col, S, reduce="amin")[:, :T]
    base = torch.where(torch.isfinite(base), base, zero)
    # per-slot work totals: the dispatch kernel's fill, a fixed-order sum
    _, tot = ops.dispatch_work_prefix(
        torch.where(valid, slot, -1).to(torch.int32), works, T)
    # per-slot task counts: whole numbers, exact in any summation order
    cnt = torch.zeros((B, T + 1), **f64).scatter_add_(
        1, col, valid.to(torch.float64))[:, :T]
    half = 0.5 * works

    queue = torch.zeros((B, n), **f64)
    resp = torch.zeros((B, M), **f64)
    fires = torch.zeros(B, **f64)
    moved = torch.zeros(B, **f64)
    seen = torch.zeros(B, **f64)
    backlog = []
    probes = ([], [], [], []) if cfg.probe else None
    for t in range(T):
        mask = slot == t                                  # (B, M)
        pw = powers * scale[t]                            # (B, n)
        pi = pw.sum(dim=1, keepdim=True)
        # -- arrivals
        tot_t = tot[:, t:t + 1]                           # (B, 1)
        has = tot_t > 0.0
        fair = pw / pi * (queue.sum(dim=1, keepdim=True) + tot_t)
        deficit = torch.clamp_min(fair - queue, 0.0)
        ds = deficit.sum(dim=1, keepdim=True)
        use_def = ds > 0.0
        src = torch.where(use_def, deficit, pw)
        norm = torch.where(use_def, ds, pi)
        lam = ops.prefix_scan(src / norm)
        frac = torch.clamp((S - base[:, t:t + 1] + half)
                           / torch.where(has, tot_t, 1.0), 0.0, 1.0 - _TINY)
        owner = torch.searchsorted(lam, frac, right=True) - 1
        owner = torch.clamp(owner, 0, n - 1)
        q_own = torch.gather(queue, 1, owner)
        pw_own = torch.gather(pw, 1, owner)
        # dispatch kernel: exclusive same-owner work prefix of this slot's
        # dispatch wave, all B scenarios in one launch; its fill is the
        # slot's per-node work increment
        ahead, fill = ops.dispatch_work_prefix(
            torch.where(mask, owner, -1).to(torch.int32),
            torch.where(mask, works, zero), n)
        backlog_ahead = ahead if cfg.fifo_dispatch else 0.0
        resp = resp + torch.where(
            mask, (q_own + backlog_ahead + works)
            / torch.clamp_min(pw_own, _TINY), zero)
        queue = queue + fill
        seen = seen + cnt[:, t]
        # -- crossover trigger (and/or the probe's trigger signal — same
        # formulas as simulate_scalar, see the note there)
        if cfg.rebalance or cfg.probe:
            w = queue.sum(dim=1, keepdim=True)
            t_bal = torch.where(pi > 0.0, w / torch.clamp_min(pi, _TINY),
                                zero)
            ratio = torch.where(pw > 0.0, queue / torch.clamp_min(pw, _TINY),
                                torch.where(queue > _TINY, inf, zero))
            imb = (ratio.amax(dim=1, keepdim=True)
                   / torch.clamp_min(t_bal, _TINY) - 1.0)
            fair_q = pw / torch.clamp_min(pi, _TINY) * w
            excess = torch.clamp_min(queue - fair_q, 0.0).sum(
                dim=1, keepdim=True)
            overhead = (cfg.scan_steps * (cfg.p + cfg.q)
                        + seen[:, None] / n * cfg.t_task
                        + excess * cfg.packets_per_unit
                        / cfg.packets_per_step * cfg.p)
            cross = overhead / torch.clamp_min(t_bal, _TINY)
            fire = (t_bal > _TINY) & (imb > torch.clamp_min(cross,
                                                            cfg.floor))
            if cfg.rebalance:
                queue = torch.where(fire, fair_q, queue)
                moved = moved + torch.where(fire[:, 0], excess[:, 0], zero)
                fires = fires + fire[:, 0].to(torch.float64)
            else:
                fire = torch.zeros_like(fire)
        # -- service (backlog sampled before draining, as in simulate_scalar)
        backlog.append(queue.sum(dim=1))
        if cfg.probe:
            for series, value in zip(probes, (queue, imb[:, 0], cross[:, 0],
                                              fire[:, 0])):
                series.append(value)
        queue = torch.clamp_min(queue - pw * cfg.dt, 0.0)

    count = cnt.sum(dim=1)
    mean = torch.where(count > 0, resp.sum(dim=1)
                       / torch.clamp_min(count, 1.0), torch.nan)
    # nearest-rank p99 with padding pushed to +inf
    if M:
        s = torch.sort(torch.where(valid, resp, inf), dim=1).values
        k = torch.ceil(0.99 * count).to(torch.int64)
        k = torch.minimum(torch.clamp_min(k, 1),
                          torch.clamp_min(count.to(torch.int64), 1))
        p99 = torch.where(count > 0,
                          torch.gather(s, 1, (k - 1)[:, None])[:, 0],
                          torch.nan)
    else:
        p99 = torch.full((B,), torch.nan, **f64)
    # makespan: last slot with backlog, +1 slot, in time units
    busy = (torch.stack(backlog) > _TINY).to(torch.int64)      # (T, B)
    last = (torch.arange(T, device=dev)[:, None] + 1) * busy
    makespan = last.amax(dim=0).to(torch.float64) * cfg.dt
    out = (mean, p99, makespan, fires, moved, count)
    if cfg.probe:
        # stacked along the leading (time) axis; hand back batch-major
        q, imb_s, cross_s, fire_s = (torch.stack(v) for v in probes)
        out = out + (q.permute(1, 0, 2), imb_s.T, cross_s.T, fire_s.T)
    return out


def simulate_batch(slot, works, powers, cfg: VectorConfig,
                   power_scale=None, *, device=None) -> BatchMetrics:
    """Run B scenarios in one batched call.

    ``slot``/``works``: (B, M); ``powers``: (n,) or (B, n);
    ``power_scale``: optional (T, n) shared up/down schedule. Runs on the
    CUDA device unless ``device`` says otherwise (see
    :func:`repro_torch.device.resolve_device`); returns numpy metrics.
    """
    tensors = to_tensors(slot, works, powers, power_scale,
                         device=resolve_device(device))
    out = tuple(v.cpu().numpy() for v in _simulate_batch_torch(*tensors, cfg))
    mean, p99, makespan, fires, moved, count = out[:6]
    probes = (dict(zip(("probe_queue", "probe_imbalance",
                        "probe_crossover", "probe_fires"), out[6:]))
              if cfg.probe else {})
    return BatchMetrics(mean_response=mean, p99_response=p99,
                        makespan=makespan, trigger_fires=fires,
                        moved_units=moved, completed=count, **probes)


def sweep_seeds(process: str, seeds, powers, cfg: VectorConfig, *,
                power_scale: np.ndarray | None = None, device=None,
                **workload_kwargs) -> BatchMetrics:
    """Generate one workload per seed and run the whole sweep in one batched
    call — the on-device replacement for a Python loop over scenarios."""
    from .workload import make_workload
    horizon = cfg.n_slots * cfg.dt
    wls = [make_workload(process, horizon=horizon, seed=int(s),
                         **workload_kwargs) for s in seeds]
    slot, works, _ = batch_slots(wls, cfg.dt, cfg.n_slots)
    return simulate_batch(slot, works, powers, cfg, power_scale=power_scale,
                          device=device)
