"""The traffic generator at small sizes: the slot layout the engine takes,
the offered load, the burst shares, and the same sweeps from the same
seed."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.manifest import BENCH_DIR

SEED = 2**31 + 7


def _load(config, cell):
    return (json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text()),
            json.loads((BENCH_DIR / "traffic" / f"{cell}.json").read_text()))


def test_powers_are_the_sources_classes():
    """Google's three CPU classes at their machine counts, Alibaba's one
    machine shape; the largest class at 10 work units a slot."""
    config, _ = _load("clusterdata-12.5k", "clusterdata-12.5k.poisson")
    powers = gen.node_powers(config)
    values, counts = np.unique(powers, return_counts=True)
    assert powers.shape == (12583,) and powers.sum() == 66590.0
    assert values.tolist() == [2.5, 5.0, 10.0]
    assert counts.tolist() == [126, 11659, 798]
    assert not (np.diff(powers) == 0).all()          # classes interleaved
    config, _ = _load("alibaba-4k", "alibaba-4k.bursty")
    powers = gen.node_powers(config)
    assert powers.shape == (4000,) and (powers == 10.0).all()


def test_class_shares_at_fewer_nodes():
    """A cut cluster keeps the classes' shares, rounded by largest
    remainder, and every node."""
    config, _ = _load("clusterdata-12.5k", "clusterdata-12.5k.poisson")
    for n in (64, 200, 1000):
        config.update(n_nodes=n)
        counts = gen.class_counts(config)
        assert counts.sum() == n
        share = np.array([126, 11659, 798]) * n / 12583
        assert (np.abs(counts - share) < 1).all()


@pytest.mark.parametrize("config_name,cell", [
    ("clusterdata-12.5k", "clusterdata-12.5k.poisson"),
    ("alibaba-4k", "alibaba-4k.bursty")])
def test_slot_layout(config_name, cell):
    config, traffic = _load(config_name, cell)
    config.update(n_nodes=200, n_slots=30)
    traffic.update(seeds_per_sweep=5)
    powers = gen.node_powers(config)
    (slot, works, tasks), = gen.draw_sweeps(traffic, config, powers, SEED, 1,
                                            "cpu")
    T = config["n_slots"]
    assert slot.dtype == np.int32 and works.dtype == np.float64
    assert slot.shape == works.shape == (5, tasks.max())
    for b in range(5):
        real = slot[b] < T
        assert real.sum() == tasks[b]
        assert real[:tasks[b]].all() and not real[tasks[b]:].any()
        assert (np.diff(slot[b][:tasks[b]]) >= 0).all()     # slot order
        assert (slot[b][tasks[b]:] == T).all()
        assert (works[b][tasks[b]:] == 0.0).all()
        w = works[b][:tasks[b]]
        assert w.min() >= 1.0 and w.max() < 11.0


def test_poisson_offers_its_load():
    config, traffic = _load("clusterdata-12.5k", "clusterdata-12.5k.poisson")
    config.update(n_nodes=500, n_slots=50)
    traffic.update(seeds_per_sweep=8)
    powers = gen.node_powers(config)
    (_, works, tasks), = gen.draw_sweeps(traffic, config, powers, SEED, 1,
                                         "cpu")
    assert traffic["load"] == 48 / 91          # the basic preset's share
    rate = gen.tasks_per_slot(traffic["load"], powers, config, traffic)
    expected = rate * config["n_slots"] * 8
    assert abs(tasks.sum() - expected) < 4 * np.sqrt(expected)
    offered = works.sum() / (8 * powers.sum() * config["n_slots"])
    assert abs(offered - traffic["load"]) < 0.02


def test_mmpp2_burst_shares():
    """The bursty-failover preset's rates as shares of its cluster's
    capacity (0.5 and 18 tasks a slot on powers summing to 91, works of
    mean 6): the high state holds 6 / (25 + 6) of the time, and the mean
    load is 25/31 x 3/91 + 6/31 x 108/91 = 25.6%."""
    config, traffic = _load("alibaba-4k", "alibaba-4k.bursty")
    assert traffic["load_low"] == 0.5 * 6 / 91
    assert traffic["load_high"] == 18 * 6 / 91
    high = gen.high_time(400, 400, 25.0, 6.0, np.random.default_rng(3))
    assert ((high >= 0) & (high <= 1)).all()
    assert abs(high.mean() - 6 / 31) < 0.02
    powers = gen.node_powers(config)
    rates, tasks = gen.scenario_pool(traffic, config, powers)
    capacity = gen.tasks_per_slot(1.0, powers, config, traffic)
    assert rates.shape == (128, 200) and tasks.shape == (128,)
    assert rates.min() >= traffic["load_low"] * capacity - 1e-6
    assert rates.max() <= traffic["load_high"] * capacity + 1e-6
    mean = (25 * 3 / 91 + 6 * 108 / 91) / 31
    assert abs(rates.mean() / capacity - mean) < 0.03
    assert abs(tasks.sum() / rates.sum() - 1) < 1e-3


def test_every_seed_draws_the_same_sizes():
    """The pool fixes each scenario's count: two seeds give the same set of
    counts, in another order, and so sweeps of one width."""
    config, traffic = _load("alibaba-4k", "alibaba-4k.bursty")
    config.update(n_nodes=100, n_slots=20)
    traffic.update(seeds_per_sweep=6)
    powers = gen.node_powers(config)
    one = gen.draw_sweeps(traffic, config, powers, 1, 2, "cpu")
    two = gen.draw_sweeps(traffic, config, powers, 2, 1, "cpu")
    _, pool_tasks = gen.scenario_pool(traffic, config, powers)
    for slot, _, tasks in one + two:
        assert sorted(tasks) == sorted(pool_tasks)
        assert slot.shape[1] == pool_tasks.max()
    assert not np.array_equal(one[0][0], two[0][0])


def test_slot_counts_follow_the_rates():
    """Given its count, a row's arrivals fall in the slots in proportion to
    its rates (a multinomial draw)."""
    g = torch.Generator().manual_seed(5)
    rates = torch.tensor([[1.0, 1.0, 2.0, 4.0]] * 2000, dtype=torch.float64)
    tasks = torch.full((2000,), 800, dtype=torch.int64)
    counts = gen._slot_counts(rates, tasks, g)
    assert (counts.sum(dim=1) == 800).all() and (counts >= 0).all()
    share = counts.double().mean(dim=0) / 800
    assert torch.allclose(share, torch.tensor([0.125, 0.125, 0.25, 0.5],
                                              dtype=torch.float64),
                          atol=2e-3)


def test_same_seed_same_sweeps_and_two_differ():
    config, traffic = _load("alibaba-4k", "alibaba-4k.bursty")
    config.update(n_nodes=100, n_slots=20)
    traffic.update(seeds_per_sweep=3)
    powers = gen.node_powers(config)
    one = gen.draw_sweeps(traffic, config, powers, SEED, 2, "cpu")
    two = gen.draw_sweeps(traffic, config, powers, SEED, 2, "cpu")
    for (s1, w1, _), (s2, w2, _) in zip(one, two):
        assert np.array_equal(s1, s2) and np.array_equal(w1, w2)
    assert not np.array_equal(one[0][1][:, :10], one[1][1][:, :10])
