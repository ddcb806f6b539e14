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

Determinism, and the oracle's bits. The engine's discrete branches (the
owner ``searchsorted``, the trigger's ``imb > max(cross, floor)``) can flip
on one bit: on bursty traces many tasks sit within a few ulps of an
interval edge, and a task sent to the neighbouring node changes every later
queue until the next rebalance. So every float64 sum that feeds a branch is
taken in ``simulate_scalar``'s own order, which also fixes it from run to
run on the card (an atomic scatter-add or ``torch.cumsum`` on CUDA floats is
neither):

* the work prefix ``S`` and the power prefix ``lam`` are the scan kernel,
  left to right like ``np.cumsum(x) - x``;
* the per-slot totals are the dispatch kernel's ``fill`` (a serial
  per-destination sum in task order, like ``np.add.at``), and a slot's
  dispatch wave is added to the queue by the same kernel started from the
  queue (``init=queue``), as ``np.add.at(queue, owner, works)`` adds it;
* every row sum (``pw.sum()``, ``queue.sum()``, ``deficit.sum()``, the
  excess) is numpy's own pairwise order, ``_np_sum``.

Elementwise float64 arithmetic is exact IEEE on both devices, so the queue,
the owners, the trigger and the moved volume equal ``simulate_scalar``'s bit
for bit. With ``fifo_dispatch`` a response adds the queue and the wave's
backlog in another order than the oracle (``(q + w1 + ...) + w`` against
``(q + (w1 + ...)) + w``), within a few ulps: responses feed no branch. The
remaining scatter-add sums whole counts, which float64 holds exactly in any
order.

Tracing. ``simulate_batch(..., tracer=)`` (and ``sweep_seeds``) records
one span tree a call on the tracer's engine lane (``obs.PID_ENGINE``):
``simulate_batch`` over ``to_tensors`` (the copies in), ``tables`` (``S``,
``base``, the totals call, ``cnt``), ``slot_loop``, ``finish`` (mean, the
p99 sort, makespan) and ``results`` (the copy back); under ``slot_loop``
each slot's ``owner_search`` (the mask to ``pw_own``), ``dispatch`` (the
wave, ``before``, the responses) and ``trigger_service`` (the trigger, the
backlog sum, the probe, the drain), with ``args.slot``. Span times are the
host's, in ``Tracer.wall_clock`` seconds: the clock ``torch.profiler``
stamps kernels with, so a device trace and the spans line up. On a CUDA
device each span also carries ``args.device_ms``, its interval on the
stream between CUDA events recorded at the phase boundaries, read once the
results are back. Each call ends with four counters: ``h2d_bytes``,
``elements_swept`` (T x B x M, what the slot loop's masked passes touch),
``tasks`` (the real ones) and ``np_sum_plan_builds``. Without a tracer the
engine reads no clock and records no event.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..obs.tracer import PID_ENGINE
from .metrics import nearest_rank
from .workload import batch_slots

__all__ = ["VectorConfig", "BatchMetrics", "simulate_batch",
           "simulate_scalar", "sweep_seeds", "to_tensors"]

_TINY = 1e-12
# numpy's float64 sum of a contiguous row: pairwise_sum halves a run (the
# cut rounded down to a multiple of 8) down to blocks of at most 128 and sums
# a block in 8 interleaved accumulators. numpy 2.0 runs it over chunks of the
# ufunc buffer (8192 elements) in turn, later versions over the whole row:
# _np_chunk asks the installed numpy which
_NP_BUFSIZE = 8192
_NP_BLOCK = 128
_NP_GROUPS = _NP_BLOCK // 8


class _NpSumPlan:
    """The fixed association tree of numpy's sum over n elements, as index
    tensors: the blocks' elements (16 groups of 8, then up to 7 left over;
    index n points at a zero, and adding 0.0 changes no bits), the pairwise
    additions level by level, and the chunks' roots in order."""

    #: plans built in this process (the tracer's ``np_sum_plan_builds``)
    built = 0

    def __init__(self, n: int, device, chunk: int):
        _NpSumPlan.built += 1
        blocks, adds = [], []

        def tree(start, length):
            if length <= _NP_BLOCK:
                blocks.append((start, length))
                return ("b", len(blocks) - 1, 0)
            half = length // 2
            half -= half % 8
            left, right = tree(start, half), tree(start + half, length - half)
            adds.append((left, right))
            return ("a", len(adds) - 1, 1 + max(left[2], right[2]))

        roots = [tree(s, min(chunk, n - s)) for s in range(0, n, chunk)]
        nb = len(blocks)
        groups = np.full((nb, _NP_GROUPS, 8), n, dtype=np.int64)
        rest = np.full((nb, 7), n, dtype=np.int64)
        for i, (start, length) in enumerate(blocks):
            g = length // 8 if length >= 8 else 0
            groups[i, :g] = start + np.arange(8 * g).reshape(g, 8)
            rest[i, :length - 8 * g] = start + 8 * g + np.arange(
                length - 8 * g)

        def vid(node):
            return node[1] if node[0] == "b" else nb + node[1]

        levels: dict[int, list] = {}
        for j, (left, right) in enumerate(adds):
            h = 1 + max(left[2], right[2])
            levels.setdefault(h, []).append((nb + j, vid(left), vid(right)))
        as_t = dict(dtype=torch.int64, device=device)
        self.size = nb + len(adds)
        self.groups = torch.as_tensor(groups, **as_t)
        self.rest = torch.as_tensor(rest, **as_t)
        self.levels = [tuple(torch.as_tensor(col, **as_t)
                             for col in zip(*levels[h]))
                       for h in sorted(levels)]
        self.roots = [vid(r) for r in roots]


_NP_SUM_PLANS: dict[tuple, _NpSumPlan] = {}
_NP_CHUNKS: dict[int, int] = {}


def _np_chunk(n: int) -> int:
    """The run length the installed numpy sums n elements in: its buffer
    (numpy 2.0) or the whole row (later versions), read off ``np.sum`` of
    probe rows whose bits tell the two apart."""
    if n <= _NP_BUFSIZE:
        return _NP_BUFSIZE
    if n not in _NP_CHUNKS:
        probe = np.random.default_rng(n).uniform(0.0, 1e3, size=(16, n))
        want = [np.sum(row) for row in probe]
        _NP_CHUNKS[n] = next(
            (c for c in (_NP_BUFSIZE, n)
             if np.array_equal(_np_sum_with(torch.from_numpy(probe),
                                            _NpSumPlan(n, "cpu", c)).numpy(),
                               want)),
            _NP_BUFSIZE)
    return _NP_CHUNKS[n]


def _np_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis with numpy's association, bit for bit what
    ``np.sum`` gives each contiguous float64 row (``simulate_scalar``'s
    sums); on any device."""
    n = x.shape[-1]
    key = (n, x.device)
    if key not in _NP_SUM_PLANS:
        _NP_SUM_PLANS[key] = _NpSumPlan(n, x.device, _np_chunk(n))
    return _np_sum_with(x, _NP_SUM_PLANS[key])


def _np_sum_with(x: torch.Tensor, plan: _NpSumPlan) -> torch.Tensor:
    n = x.shape[-1]
    lead = x.shape[:-1]
    out = torch.zeros(lead, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    xp = torch.cat([x, x.new_zeros(lead + (1,))], dim=-1)
    g = xp[..., plan.groups]                         # (..., blocks, 16, 8)
    r = g[..., 0, :]
    for k in range(1, _NP_GROUPS):
        r = r + g[..., k, :]
    block = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
             + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
    rest = xp[..., plan.rest]                        # (..., blocks, 7)
    for k in range(7):
        block = block + rest[..., k]
    vals = torch.empty(lead + (plan.size,), dtype=x.dtype, device=x.device)
    vals[..., :block.shape[-1]] = block
    for ids, left, right in plan.levels:
        vals[..., ids] = vals[..., left] + vals[..., right]
    for root in plan.roots:
        out = out + vals[..., root]
    return out


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

_SLOT_PHASES = ("owner_search", "dispatch", "trigger_service")


class _CallSpans:
    """One traced ``simulate_batch`` call. ``mark(name)`` ends phase
    ``name`` where the last mark ended it: the host's time on the tracer's
    clock and, on a CUDA device, an event on the stream from a pool made
    here. ``close`` turns the marks into the span tree (slot phases under
    ``slot_loop``, the rest under ``simulate_batch``) and the counters."""

    def __init__(self, tracer, device: torch.device, n_slots: int,
                 args: dict):
        self.tracer = tracer
        self.args = args
        self.marks: list = []
        self.events = None
        if device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            # the call's own marks: one each for its start, to_tensors,
            # tables, finish and results, three a slot
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(3 * n_slots + 5)]
        self.builds = _NpSumPlan.built
        self.mark(None)

    def mark(self, name, args=None):
        if self.events is not None:
            self.events[len(self.marks)].record(self.stream)
        self.marks.append((name, self.tracer.wall_clock(), args))

    def _device_ms(self, i: int, j: int) -> dict:
        if self.events is None:
            return {}
        return {"device_ms": self.events[i].elapsed_time(self.events[j])}

    def close(self, counters: dict) -> None:
        tr, marks = self.tracer, self.marks
        if self.events is not None:
            self.events[len(marks) - 1].synchronize()
        root = tr.next_span_id()
        ids = {"trace_id": root}
        names = [m[0] for m in marks]
        # the loop's span: from the tables' end to its last phase's end
        first = names.index("tables")
        last = max([first] + [i for i, name in enumerate(names)
                              if name in _SLOT_PHASES])
        loop = tr.next_span_id()

        def span(name, i, j, args):
            tr.span(name, marks[i][1], marks[j][1], pid=PID_ENGINE,
                    cat="engine", args={**args, **self._device_ms(i, j)})

        span("simulate_batch", 0, len(marks) - 1,
             {**ids, "span_id": root, **self.args})
        span("slot_loop", first, last,
             {**ids, "span_id": loop, "parent_id": root})
        for i in range(1, len(marks)):
            name, _, args = marks[i]
            parent = loop if name in _SLOT_PHASES else root
            span(name, i - 1, i, {**ids, "span_id": tr.next_span_id(),
                                  "parent_id": parent, **(args or {})})
        t_end = marks[-1][1]
        counters = {**counters,
                    "np_sum_plan_builds": _NpSumPlan.built - self.builds}
        for name, value in counters.items():
            tr.counter(name, t_end, {name: value}, pid=PID_ENGINE)


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


def _simulate_batch_torch(slot, works, powers, scale, cfg: VectorConfig,
                          spans: _CallSpans | None = None):
    """The batched engine on tensors of one device: the JAX package's
    ``_simulate_batch_jax``, with every branch-feeding sum in
    ``simulate_scalar``'s order (see the module docstring). Returns a tuple
    of tensors:
    ``(mean, p99, makespan, fires, moved, count)`` and, with ``cfg.probe``,
    ``(probe_queue, probe_imbalance, probe_crossover, probe_fires)``.
    ``spans`` marks the ends of ``tables``, of each slot's phases and of
    ``finish``."""
    B, M = works.shape
    T, n = cfg.n_slots, cfg.n_nodes
    dev = works.device
    f64 = dict(dtype=torch.float64, device=dev)
    if scale is None:
        scale = torch.ones((T, n), **f64)
    inf = torch.tensor(float("inf"), **f64)
    zero = torch.zeros((), **f64)

    # one batched exclusive work scan over all tasks — the paper's core
    # operator, computed by the scan kernel (left to right, as np.cumsum)
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
    if spans is not None:
        spans.mark("tables")
    for t in range(T):
        mask = slot == t                                  # (B, M)
        pw = powers * scale[t]                            # (B, n)
        pi = _np_sum(pw)[:, None]
        # -- arrivals
        tot_t = tot[:, t:t + 1]                           # (B, 1)
        has = tot_t > 0.0
        fair = pw / pi * (_np_sum(queue)[:, None] + tot_t)
        deficit = torch.clamp_min(fair - queue, 0.0)
        ds = _np_sum(deficit)[:, None]
        use_def = ds > 0.0
        src = torch.where(use_def, deficit, pw)
        norm = torch.where(use_def, ds, pi)
        lam = ops.prefix_scan(src / norm)
        frac = torch.clamp((S - base[:, t:t + 1] + half)
                           / torch.where(has, tot_t, 1.0), 0.0, 1.0 - _TINY)
        owner = torch.searchsorted(lam, frac, right=True) - 1
        owner = torch.clamp(owner, 0, n - 1)
        pw_own = torch.gather(pw, 1, owner)
        if spans is not None:
            spans.mark("owner_search", {"slot": t})
        # dispatch kernel, all B scenarios in one launch: this slot's wave
        # added to the queues in task order (started from the queue, as
        # np.add.at adds), and each task's queue plus the same-owner work
        # ahead of it in the wave
        ahead, new_queue = ops.dispatch_work_prefix(
            torch.where(mask, owner, -1).to(torch.int32),
            torch.where(mask, works, zero), n, init=queue)
        before = (ahead if cfg.fifo_dispatch
                  else torch.gather(queue, 1, owner))
        resp = resp + torch.where(
            mask, (before + works) / torch.clamp_min(pw_own, _TINY), zero)
        queue = new_queue
        seen = seen + cnt[:, t]
        if spans is not None:
            spans.mark("dispatch", {"slot": t})
        # -- crossover trigger (and/or the probe's trigger signal — same
        # formulas as simulate_scalar, see the note there)
        if cfg.rebalance or cfg.probe:
            w = _np_sum(queue)[:, None]
            t_bal = torch.where(pi > 0.0, w / torch.clamp_min(pi, _TINY),
                                zero)
            ratio = torch.where(pw > 0.0, queue / torch.clamp_min(pw, _TINY),
                                torch.where(queue > _TINY, inf, zero))
            imb = (ratio.amax(dim=1, keepdim=True)
                   / torch.clamp_min(t_bal, _TINY) - 1.0)
            fair_q = pw / torch.clamp_min(pi, _TINY) * w
            excess = _np_sum(torch.clamp_min(queue - fair_q, 0.0))[:, None]
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
        backlog.append(_np_sum(queue))
        if cfg.probe:
            for series, value in zip(probes, (queue, imb[:, 0], cross[:, 0],
                                              fire[:, 0])):
                series.append(value)
        queue = torch.clamp_min(queue - pw * cfg.dt, 0.0)
        if spans is not None:
            spans.mark("trigger_service", {"slot": t})

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
    if spans is not None:
        spans.mark("finish")
    return out


def _h2d_bytes(slot, works, powers, power_scale) -> int:
    """Bytes ``to_tensors`` copies in: int32 slots, float64 the rest (the
    powers as given, broadcast on the device)."""
    return (4 * np.size(slot) + 8 * (np.size(works) + np.size(powers))
            + (0 if power_scale is None else 8 * np.size(power_scale)))


def simulate_batch(slot, works, powers, cfg: VectorConfig,
                   power_scale=None, *, device=None,
                   tracer=None) -> BatchMetrics:
    """Run B scenarios in one batched call.

    ``slot``/``works``: (B, M); ``powers``: (n,) or (B, n);
    ``power_scale``: optional (T, n) shared up/down schedule. Runs on the
    CUDA device unless ``device`` says otherwise (see
    :func:`repro_torch.device.resolve_device`); returns numpy metrics.

    ``tracer``: an ``obs.Tracer`` that gets the call's span tree on its
    ``PID_ENGINE`` lane, on the profiler's clock, and its counters (see
    the module docstring: what each span covers, ``args.device_ms`` on a
    CUDA device); the metrics are the same bits with or without it.
    """
    device = resolve_device(device)
    spans = None
    if tracer is not None:
        B, M = np.shape(works)
        h2d = _h2d_bytes(slot, works, powers, power_scale)
        spans = _CallSpans(tracer, device, cfg.n_slots,
                           {"B": B, "M": M, "T": cfg.n_slots,
                            "n": cfg.n_nodes})
    tensors = to_tensors(slot, works, powers, power_scale, device=device)
    if spans is not None:
        spans.mark("to_tensors", {"h2d_bytes": h2d})
    out = tuple(v.cpu().numpy()
                for v in _simulate_batch_torch(*tensors, cfg, spans))
    mean, p99, makespan, fires, moved, count = out[:6]
    if spans is not None:
        spans.mark("results")
        spans.close({"h2d_bytes": h2d,
                     "elements_swept": cfg.n_slots * B * M,
                     "tasks": int(count.sum())})
    probes = (dict(zip(("probe_queue", "probe_imbalance",
                        "probe_crossover", "probe_fires"), out[6:]))
              if cfg.probe else {})
    return BatchMetrics(mean_response=mean, p99_response=p99,
                        makespan=makespan, trigger_fires=fires,
                        moved_units=moved, completed=count, **probes)


def sweep_seeds(process: str, seeds, powers, cfg: VectorConfig, *,
                power_scale: np.ndarray | None = None, device=None,
                tracer=None, **workload_kwargs) -> BatchMetrics:
    """Generate one workload per seed and run the whole sweep in one batched
    call — the on-device replacement for a Python loop over scenarios.
    ``tracer`` traces the call as :func:`simulate_batch` says (the
    workloads' generation is outside its spans)."""
    from .workload import make_workload
    horizon = cfg.n_slots * cfg.dt
    wls = [make_workload(process, horizon=horizon, seed=int(s),
                         **workload_kwargs) for s in seeds]
    slot, works, _ = batch_slots(wls, cfg.dt, cfg.n_slots)
    return simulate_batch(slot, works, powers, cfg, power_scale=power_scale,
                          device=device, tracer=tracer)
