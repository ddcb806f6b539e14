"""PSTS request -> replica scheduler for continuous-batching serving: a
copy of the JAX package's module (plain numpy), its imports pointed at the
port's ``core`` and ``runtime``.

Requests are the paper's tasks: work beta = estimated prefill + decode cost,
transfer mu = KV-cache bytes. New arrivals use the cheap positional rule
(paper Table 7: per-arrival crossover is tiny, so place-on-arrival is almost
always worth it); full rebalancing (migrating running requests between
replicas, i.e. KV transfer) runs only when the crossover trigger fires —
exactly the paper's operating policy."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.hypergrid import HyperGrid
from ..core.psts import psts_schedule
from ..core.trigger import CrossoverTrigger
from ..runtime.policies import PstsPolicy, positional_arrival, register

__all__ = ["Request", "ReplicaScheduler", "RequestSchedulerPolicy"]


@dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    replica: int = -1
    decoded: int = 0

    @property
    def work(self) -> float:
        """beta: prefill is compute-bound (~quadratic-ish, amortised linear
        per token with flash), decode memory-bound per token."""
        remaining = self.max_new_tokens - self.decoded
        return float(self.prompt_len + 4.0 * max(remaining, 0))

    @property
    def kv_packets(self) -> float:
        """mu: migration cost — cache size grows with generated tokens."""
        return float(self.prompt_len + self.decoded)


@dataclass
class ReplicaScheduler:
    """Continuous batching across replicas of one model.

    dims: replica hyper-grid, e.g. (pods, replicas_per_pod).
    p/q/t_task: crossover-trigger cost constants (seconds per comm step /
    scan step / placement).
    """

    dims: tuple[int, ...]
    powers: np.ndarray | None = None
    p: float = 1e-4
    q: float = 1e-5
    t_task: float = 1e-5
    packets_per_step: float = 4096.0   # KV tokens migrated per comm step
    trigger_floor: float = 0.1
    # optional tracer with a decision(kind, seconds) method: records
    # per-decision wall latency
    # ("place" on submit, "trigger"/"rebalance" in maybe_rebalance)
    tracer: object | None = None

    _requests: dict[int, Request] = field(default_factory=dict)
    _next_id: itertools.count = field(default_factory=itertools.count)

    def __post_init__(self):
        n = int(np.prod(self.dims))
        powers = (np.ones(n) if self.powers is None
                  else np.asarray(self.powers, dtype=np.float64))
        self.grid = HyperGrid(tuple(self.dims), powers)
        self.trigger = CrossoverTrigger(
            self.grid, p=self.p, q=self.q, t_task=self.t_task,
            packets_per_step=self.packets_per_step, floor=self.trigger_floor)

    # ------------------------------------------------------------------
    def loads(self) -> np.ndarray:
        loads = np.zeros(self.grid.capacity)
        for r in self._requests.values():
            loads[r.replica] += r.work
        return loads

    def submit(self, prompt_len: int, max_new_tokens: int) -> Request:
        """Place a new arrival by the positional rule (Table 7 fast path):
        the request lands in the power interval with the most headroom —
        computed from the load and power scans, no global reshuffle."""
        req = Request(next(self._next_id), prompt_len, max_new_tokens)
        t0 = time.perf_counter()
        req.replica = positional_arrival(self.loads(), self.grid.powers,
                                         req.work)
        if self.tracer is not None:
            self.tracer.decision("place", time.perf_counter() - t0)
        self._requests[req.rid] = req
        return req

    def step_decode(self, tokens: int = 1) -> list[int]:
        """Advance decoding; returns finished request ids."""
        done = []
        for r in self._requests.values():
            r.decoded += tokens
            if r.decoded >= r.max_new_tokens:
                done.append(r.rid)
        for rid in done:
            del self._requests[rid]
        return done

    def maybe_rebalance(self) -> dict | None:
        """Run PSTS over running requests if the crossover trigger fires.
        Returns a migration plan {rid: (src, dst)} or None."""
        reqs = list(self._requests.values())
        if not reqs:
            return None
        loads = self.loads()
        mig_est = sum(r.kv_packets for r in reqs) * 0.3  # rough volume
        t0 = time.perf_counter()
        dec = self.trigger.evaluate(loads, m_tasks=len(reqs),
                                    moved_packets_estimate=mig_est)
        if self.tracer is not None:
            self.tracer.decision("trigger", time.perf_counter() - t0)
        if not dec.trigger:
            return None
        works = np.array([r.work for r in reqs])
        node = np.array([r.replica for r in reqs])
        t0 = time.perf_counter()
        res = psts_schedule(works, node, self.grid)
        if self.tracer is not None:
            self.tracer.decision("rebalance", time.perf_counter() - t0)
        plan = {}
        for r, dst in zip(reqs, res.dest):
            if dst != r.replica:
                plan[r.rid] = (r.replica, int(dst))
                r.replica = int(dst)
        return plan

    def runtime_policy(self) -> "RequestSchedulerPolicy":
        """This scheduler's placement rule + trigger constants as a
        cluster-runtime policy, so serving traffic can be studied under the
        same event engine (and the same Metrics) as every other policy."""
        return RequestSchedulerPolicy(
            p=self.p, q=self.q, t_task=self.t_task,
            packets_per_step=self.packets_per_step, floor=self.trigger_floor)

    def fail_replica(self, idx: int) -> dict:
        """Elastic path: replica dies -> virtual node; its requests migrate
        by PSTS immediately (stranded work = infinite imbalance)."""
        self.grid = self.grid.fail(idx)
        self.trigger = CrossoverTrigger(
            self.grid, p=self.p, q=self.q, t_task=self.t_task,
            packets_per_step=self.packets_per_step, floor=self.trigger_floor)
        reqs = list(self._requests.values())
        if not reqs:
            return {}
        works = np.array([r.work for r in reqs])
        node = np.array([r.replica for r in reqs])
        res = psts_schedule(works, node, self.grid)
        plan = {}
        for r, dst in zip(reqs, res.dest):
            if dst != r.replica:
                plan[r.rid] = (r.replica, int(dst))
                r.replica = int(dst)
        return plan


@register("replica")
@dataclass
class RequestSchedulerPolicy(PstsPolicy):
    """The serving request scheduler as a cluster-runtime policy.

    Identical decision logic to ``ReplicaScheduler`` — positional placement
    on arrival, crossover-trigger-gated PSTS rebalancing — but driven by the
    event engine, so it can be compared head-to-head with the baselines in
    ``runtime.policies`` on the same workloads and metrics. Defaults
    are the serving-tier cost constants (seconds-scale steps, KV-sized
    migration batches) rather than the generic cluster ones.
    """

    p: float = 1e-4
    q: float = 1e-5
    t_task: float = 1e-5
    packets_per_step: float = 4096.0
    floor: float = 0.1
