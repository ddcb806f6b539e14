"""The port's serving path on the CPU against the JAX package: ``Engine.run``
generates the same tokens as the JAX engine on granite-moe's smoke config
(at the default capacity factor, where slots overflow and PSTS re-routes,
and at 8.0) and on falcon-mamba's and jamba's (SSM and hybrid caches);
``ReplicaScheduler`` makes the same placements and the same rebalance /
failover plans; the numpy ``psts_schedule`` copy equals the JAX package's;
and the serve CLI runs end to end with ``--device cpu``, for granite-moe
and falcon-mamba."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine (imported by repro.runtime) imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.hypergrid import HyperGrid  # noqa: E402
from repro.core.psts import psts_schedule as jax_psts  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.sched.request_sched import ReplicaScheduler as JaxSched  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import GenRequest as JaxRequest  # noqa: E402
from repro_torch.core import HyperGrid as PortGrid  # noqa: E402
from repro_torch.core import psts_schedule  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import LM, from_jax_params  # noqa: E402
from repro_torch.runtime import make_policy  # noqa: E402
from repro_torch.sched.request_sched import (  # noqa: E402
    ReplicaScheduler,
    RequestSchedulerPolicy,
)
from repro_torch.serve import Engine, GenRequest  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
PROMPT_LENS = (5, 9, 13, 40, 7, 22)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_engine_generates_the_jax_engines_tokens(capacity_factor):
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").smoke(),
                              capacity_factor=capacity_factor)
    jlm = JaxLM(cfg)
    params = jlm.init(jax.random.key(0))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                         params)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    # 4 slots for 6 requests: slots are reused, prompts are bucketed
    want = JaxEngine(jlm, params, slots=4, max_len=96).run(
        [JaxRequest(i, p, 8) for i, p in enumerate(prompts)])
    got = Engine(lm, slots=4, max_len=96).run(
        [GenRequest(i, p, 8) for i, p in enumerate(prompts)])
    assert len(got) == len(prompts)
    assert {r.rid: r.generated for r in got} == \
        {r.rid: [int(t) for t in r.generated] for r in want}


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_engine_generates_the_jax_engines_tokens_with_ssm_caches(arch):
    """Slot reuse over SSM state and conv caches (and, for jamba, the
    attention sub-layer's KV cache beside them): each admission copies a
    prefill batch's caches into free slots whole."""
    cfg = get_config(arch).smoke()
    jlm = JaxLM(cfg)
    params = jlm.init(jax.random.key(0))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                         params)))
    rng = np.random.default_rng(1)
    # one prompt bucket (32): the JAX engine compiles one prefill
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 13, 30, 7, 22)]
    want = JaxEngine(jlm, params, slots=4, max_len=96).run(
        [JaxRequest(i, p, 6) for i, p in enumerate(prompts)])
    got = Engine(lm, slots=4, max_len=96).run(
        [GenRequest(i, p, 6) for i, p in enumerate(prompts)])
    assert len(got) == len(prompts)
    assert {r.rid: r.generated for r in got} == \
        {r.rid: [int(t) for t in r.generated] for r in want}


def test_engine_refuses_a_bucket_beyond_max_len():
    lm = LM(get_config("olmo-1b").smoke(), device="cpu")
    eng = Engine(lm, slots=2, max_len=40)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.admit([GenRequest(0, np.zeros(33, np.int32), 2)])


def test_engine_sampling_repeats_under_one_seed():
    """greedy=False samples from the softmax with a seeded generator: the
    same seed draws the same tokens (the JAX engine's draws differ)."""
    lm = LM(get_config("olmo-1b").smoke(), device="cpu")
    lm.init(torch.Generator().manual_seed(0))
    prompt = np.arange(1, 9, dtype=np.int32)

    def run(seed):
        eng = Engine(lm, slots=2, max_len=64, greedy=False, seed=seed)
        return [r.generated for r in eng.run(
            [GenRequest(i, prompt, 12) for i in range(2)])]
    first = run(5)
    assert first == run(5)
    assert all(len(g) == 12 for g in first)
    assert all(0 <= t < lm.cfg.vocab_padded for g in first for t in g)


def _drive(sched_cls, dims, powers=None):
    """A fixed submit / decode / rebalance / failover sequence."""
    s = sched_cls(dims=dims, powers=powers)
    rng = np.random.default_rng(7)
    placed = [s.submit(int(rng.integers(16, 2048)),
                       int(rng.integers(8, 256))).replica for _ in range(40)]
    # skew the loads so the crossover trigger fires
    for rid in range(0, 40, 3):
        s._requests[rid].replica = 0
    plans = [s.maybe_rebalance()]
    s.step_decode(64)
    placed += [s.submit(int(rng.integers(16, 2048)), 32).replica
               for _ in range(10)]
    plans.append(s.maybe_rebalance())
    plans.append(s.fail_replica(1))
    return placed, plans, s.loads().tolist()


@pytest.mark.parametrize("dims,powers", [((4,), None),
                                         ((2, 3), [1, 2, 3, 1, 2, 3])])
def test_replica_scheduler_matches_jax(dims, powers):
    want = _drive(JaxSched, dims, powers)
    got = _drive(ReplicaScheduler, dims, powers)
    assert got == want
    assert want[1][0]              # the trigger fired and moved requests


def test_replica_policy_is_registered():
    pol = make_policy("replica", floor=0.2)
    assert isinstance(pol, RequestSchedulerPolicy) and pol.floor == 0.2


@pytest.mark.parametrize("dims,m,seed", [((8,), 50, 0), ((2, 4), 200, 1),
                                         ((3, 3, 2), 500, 2)])
def test_psts_schedule_matches_jax(dims, m, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(dims))
    powers = rng.integers(1, 10, size=n).astype(float)
    works = rng.exponential(3.0, size=m)
    node = rng.integers(0, n, size=m)
    want = jax_psts(works, node, HyperGrid(dims, powers))
    got = psts_schedule(works, node, PortGrid(dims, powers))
    np.testing.assert_array_equal(got.dest, want.dest)
    np.testing.assert_array_equal(got.loads_after, want.loads_after)
    np.testing.assert_array_equal(got.inter_grid_units,
                                  want.inter_grid_units)
    assert got.moved_units == want.moved_units


def test_serve_cli_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-moe-1b-a400m", "--smoke", "--device", "cpu", "--requests",
         "4", "--replicas", "2"],
        env=env, check=True, capture_output=True, text=True, timeout=300)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["finished"] == 4
    assert rec["generated_tokens"] == 4 * 8
    assert len(rec["replica_loads"]) == 2


def test_serve_cli_serves_falcon_mamba_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "falcon-mamba-7b", "--smoke", "--device", "cpu", "--requests", "6",
         "--slots", "2", "--replicas", "2"],
        env=env, check=True, capture_output=True, text=True, timeout=300)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["finished"] == 6
    assert rec["generated_tokens"] == 6 * 8
    assert len(rec["replica_loads"]) == 2


def test_serve_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve_cli.main(["--arch", "granite-moe-1b-a400m", "--smoke"])
