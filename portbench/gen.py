"""The traffic generator: a sweep's task streams, drawn on the card from the
run's seed, in the batched engine's slot layout.

A frozen rewrite of ``repro_torch.runtime.workload``'s ``poisson_arrivals``,
``bursty_arrivals`` and ``sample_works("uniform")``, binned to slots as
``batch_slots`` bins them:

* ``poisson``: a constant rate of ``load`` x capacity;
* ``mmpp2``: a two-state Markov-modulated Poisson process that starts low and
  alternates exponential sojourns (means ``sojourn_low``, ``sojourn_high``
  slots) at ``load_low`` and ``load_high`` x capacity; a slot's rate is the
  two rates weighted by the time it spends in each state.

Capacity is the cluster's service in tasks a slot: the sum of the node
powers times ``dt`` over the mean work. A row holds a scenario's tasks in
slot order, then padding (slot ``n_slots``, work 0) up to the sweep's
largest scenario, as ``batch_slots`` pads.

The same set of sizes for every seed. A sweep's width is its largest
scenario, and the engine's work follows the width: every slot passes over
the whole (B, M) array, and the dispatch kernel takes a faster path where
M is a multiple of 4. A sweep drawn afresh from each seed would do another
amount of work each run. So each scenario's rate path and task count come
from the mix's ``pool_seed`` (NumPy, on the host: B counts and a (B, T)
path), and the run's seed draws the scenarios' order, when in the horizon
each task arrives, and every work. Given its count, a Poisson process's
arrivals fall in the slots as a multinomial draw over the rate's shares of
the horizon, drawn here as a chain of binomials, one a slot.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["class_counts", "node_powers", "tasks_per_slot", "high_time", "scenario_pool",
           "draw_sweep", "draw_sweeps"]


def class_counts(config: dict) -> np.ndarray:
    """Machines of each of the config's ``machine_classes`` among its
    ``n_nodes``: the source's counts where ``n_nodes`` is their sum, and
    else the same shares rounded by largest remainder."""
    machines = np.array([c["machines"] for c in config["machine_classes"]],
                        dtype=np.int64)
    n = int(config["n_nodes"])
    exact = machines * n / machines.sum()
    counts = np.floor(exact).astype(np.int64)
    short = n - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:short]] += 1
    return counts


def node_powers(config: dict) -> np.ndarray:
    """(n,) float64 node powers: each machine class's share of the nodes at
    ``cpu`` x ``power_per_cpu`` work units a slot, in an order drawn from
    ``power_seed`` (a trace's machine ids do not group its classes)."""
    cpu = np.array([c["cpu"] for c in config["machine_classes"]],
                   dtype=np.float64)
    powers = np.repeat(cpu * float(config["power_per_cpu"]),
                       class_counts(config))
    return np.random.default_rng(config["power_seed"]).permutation(powers)


def tasks_per_slot(load: float, powers: np.ndarray, config: dict,
                   traffic: dict) -> float:
    """The arrival rate, in tasks a slot, that offers ``load`` x the
    cluster's capacity."""
    return (load * float(powers.sum()) * config["dt"]
            / traffic["works"]["mean"])


def high_time(rows: int, n_slots: int, sojourn_low: float,
              sojourn_high: float, rng: np.random.Generator) -> np.ndarray:
    """(rows, n_slots): the time each slot spends in the high state of an
    MMPP-2 path that starts low (sojourns in slots)."""
    # twice the mean number of cycles in the horizon, and 8 more
    pairs = int(2 * n_slots / (sojourn_low + sojourn_high)) + 8
    low = rng.exponential(sojourn_low, size=(rows, pairs))
    high = rng.exponential(sojourn_high, size=(rows, pairs))
    ends = np.stack([low, high], axis=-1).reshape(rows, 2 * pairs)
    ends = ends.cumsum(axis=1)
    if not (ends[:, -1] >= n_slots).all():
        raise ValueError("an MMPP-2 path ended before the horizon")
    starts, stops = ends[:, 0::2], ends[:, 1::2]          # high sojourns
    edges = np.arange(n_slots + 1, dtype=np.float64)
    # high time in [0, x) at every slot edge x, then per slot
    below = np.clip(np.minimum(edges[None, None, :], stops[..., None])
                    - starts[..., None], 0.0, None).sum(axis=1)
    return np.clip(below[:, 1:] - below[:, :-1], 0.0, 1.0)   # rounding


def scenario_pool(traffic: dict, config: dict,
                  powers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(rates (B, T), tasks (B,))`` of the mix's B scenarios, from its
    ``pool_seed``: each slot's expected arrivals, and each scenario's task
    count, a Poisson draw of its rates' sum."""
    rows, T = int(traffic["seeds_per_sweep"]), config["n_slots"]
    rng = np.random.default_rng(int(traffic["pool_seed"]))
    process = traffic["process"]
    if process == "poisson":
        rate = tasks_per_slot(traffic["load"], powers, config, traffic)
        rates = np.full((rows, T), rate)
    elif process == "mmpp2":
        dt = config["dt"]
        high = high_time(rows, T, float(traffic["sojourn_low"]) / dt,
                         float(traffic["sojourn_high"]) / dt, rng)
        lo = tasks_per_slot(traffic["load_low"], powers, config, traffic)
        hi = tasks_per_slot(traffic["load_high"], powers, config, traffic)
        rates = lo * (1.0 - high) + hi * high
    else:
        raise ValueError(f"unknown arrival process {process!r}; have "
                         f"poisson, mmpp2")
    return rates, rng.poisson(rates.sum(axis=1)).astype(np.int64)


def _slot_counts(rates: torch.Tensor, tasks: torch.Tensor,
                 g: torch.Generator) -> torch.Tensor:
    """(B, T) int64 arrivals a slot: each row's ``tasks`` spread over its
    slots in proportion to ``rates``, one binomial draw a slot."""
    left = tasks.to(torch.float64)
    share_left = rates.sum(dim=1)
    counts = torch.empty(rates.shape, dtype=torch.int64,
                         device=rates.device)
    T = rates.shape[1]
    for t in range(T):
        if t == T - 1:
            c = left
        else:
            p = (rates[:, t] / share_left).clamp(0.0, 1.0)
            c = torch.binomial(left, p, generator=g)
        counts[:, t] = c.to(torch.int64)
        left = left - c
        share_left = share_left - rates[:, t]
    return counts


def draw_sweep(traffic: dict, config: dict, pool, g: torch.Generator,
               device):
    """One sweep's ``(slot (B, M) int32, works (B, M) float64, tasks (B,)
    int64)`` tensors on ``device``, from the ``pool`` of scenarios."""
    rates, tasks = (torch.as_tensor(a, device=device) for a in pool)
    rows, T = tasks.shape[0], config["n_slots"]
    works_spec = traffic["works"]
    if works_spec["dist"] != "uniform":
        raise ValueError(f"unknown work distribution {works_spec['dist']!r}")
    order = torch.randperm(rows, generator=g, device=device)
    rates, tasks = rates[order], tasks[order]
    ends = _slot_counts(rates, tasks, g).cumsum(dim=1)   # (B, T) slot ends
    width = int(tasks.max())
    index = torch.arange(width, device=device).expand(rows, width)
    slot = torch.searchsorted(ends, index.contiguous(), right=True,
                              out_int32=True)       # T past a row's tasks
    mean = float(works_spec["mean"])
    works = torch.rand((rows, width), dtype=torch.float64, device=device,
                       generator=g)
    works = torch.where(slot < T, 1.0 + (2.0 * mean - 2.0) * works, 0.0)
    return slot, works, tasks


def draw_sweeps(traffic: dict, config: dict, powers: np.ndarray, seed: int,
                count: int, device) -> list:
    """``count`` distinct sweeps from ``seed``, as host arrays ``(slot,
    works, tasks)``: what the engine's entry takes, and what the reference
    reads."""
    pool = scenario_pool(traffic, config, powers)
    g = torch.Generator(device=device).manual_seed(int(seed))
    sweeps = []
    for _ in range(count):
        slot, works, tasks = draw_sweep(traffic, config, pool, g, device)
        sweeps.append((slot.cpu().numpy(), works.cpu().numpy(),
                       tasks.cpu().numpy()))
        del slot, works, tasks
    return sweeps
