"""The port's training path against the JAX package's on the CPU.

* ``make_train_step`` against the JAX one from the same state (converted by
  ``from_jax_state``) for 3 steps: plain (dense, MoE and Mamba archs) and
  with ``microbatches=2``; one step with ``compress_dcn=True`` (see its
  test for the elements at an int8 rounding boundary). Parameters within 1e-5
  x each leaf's max|p|, the loss within 1e-5 relative, the same metric
  keys: both sides compute in float32, in other summation orders. Both
  optimizers run with ``eps=1e-4``: Adam divides each element's step by
  that element's own gradient scale, so at the default 1e-8 an element
  whose gradient is as small as the float32 noise of the two gradient
  computations (~1e-9 here) takes a step of O(lr) in a direction the noise
  picks (measured after 3 steps: up to 1.1e-4 x max|p|). The optimizer at
  its default eps is held against the JAX one on identical gradients in
  ``test_torch_optim.py``.
* ``train()``: the first 5 losses of the loop against the JAX loop's
  within 1e-4 relative, both started from one state (each restores it from
  its own checkpoint directory at step 0), the pipeline's batches alike.
* The reference's training cases (``tests/test_train_integration.py`` and
  ``tests/test_compressed_step.py``) mirrored on the port, a SIGTERM that
  stops the loop with a final checkpoint, and the CLI.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as jopt
from repro.configs import REGISTRY
from repro.data import DocStream as JaxDocStream
from repro.data import Pipeline as JaxPipeline
from repro.models import LM as JaxLM
from repro.optim.compress import CompressionState as JaxCompression
from repro.train import LoopConfig as JaxLoopConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import train as jax_train
from repro.train.step import CompressedTrainState as JaxCompressed
from repro_torch import optim
from repro_torch.checkpoint import latest_step, save
from repro_torch.configs import get_config as port_config
from repro_torch.data import DocStream, Pipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, from_jax_params, from_jax_state
from repro_torch.optim import AdamW, constant, warmup_cosine
from repro_torch.optim.compress import CompressionState
from repro_torch.sched.straggler import StragglerMonitor
from repro_torch.train import (
    CompressedTrainState,
    LoopConfig,
    TrainState,
    init_state,
    make_train_step,
    train,
)

SRC = Path(__file__).resolve().parents[1] / "src"
PARAM_TOL = 1e-5
LOOP_RTOL = 1e-4
STEP_EPS = 1e-4     # see the module docstring


def _from_jax(arch, jstate):
    """The port's LM and TrainState at the JAX state ``jstate``."""
    cfg = REGISTRY[arch].smoke()
    state_dict, opt = from_jax_state(cfg, jax.tree.map(np.asarray, jstate))
    lm = LM(port_config(arch).smoke(), device="cpu")
    lm.load_state_dict(state_dict)
    return lm, TrainState(init_state(lm, AdamW()).params, opt)


def _close_params(lm, jparams, cfg):
    want = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    got = dict(lm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        err = np.abs(got[name].detach().numpy() - w).max()
        assert err <= PARAM_TOL * np.abs(w).max(), name


def _batches(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        yield {"tokens": tokens, "labels": labels}


def _steps(arch, sch, jsch, **kw):
    """The JAX and the port's train steps from one converted state."""
    cfg = REGISTRY[arch].smoke()
    jlm = JaxLM(cfg)
    jstate = jax_init_state(jlm, jopt.AdamW(), jax.random.key(0))
    lm, state = _from_jax(arch, jstate)
    jstep = jax.jit(jax_make_train_step(
        jlm, jopt.AdamW(weight_decay=0.1, eps=STEP_EPS), jsch, **kw))
    step = make_train_step(lm, AdamW(weight_decay=0.1, eps=STEP_EPS), sch,
                           **kw)
    return cfg, lm, (jstate, jstep), (state, step)


@pytest.mark.parametrize("arch,microbatches", [
    ("olmo-1b", 1), ("granite-moe-1b-a400m", 1), ("falcon-mamba-7b", 1),
    ("olmo-1b", 2)])
def test_train_step_matches_jax(arch, microbatches):
    cfg, lm, (jstate, jstep), (state, step) = _steps(
        arch, warmup_cosine(3e-3, 1, 10), jopt.warmup_cosine(3e-3, 1, 10),
        remat=False, clip_norm=0.5, microbatches=microbatches)
    for batch in _batches(cfg, 3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        assert sorted(m) == sorted(jm)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=PARAM_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=PARAM_TOL)
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    _close_params(lm, jstate.params, cfg)


def test_compressed_train_step_matches_jax():
    """One step with int8 DCN compression. An element whose corrected
    gradient lies within float32 noise of a rounding boundary takes the
    neighbouring int8 code on one side (one quantisation step, the leaf's
    max|g| / 127, apart); every other element of the error-feedback buffer
    and of the parameters is held at 1e-5 x the leaf's scale, and the flipped
    ones are few, their error one step, their parameter within 2 lr. The
    buffer is held at 1e-5 x the leaf's max|g| (127 quanta), the noise it
    carries from the gradient."""
    lr = 1e-3
    cfg, lm, (jstate, jstep), (state, step) = _steps(
        "olmo-1b", constant(lr), jopt.constant(lr), remat=False,
        clip_norm=0.5, compress_dcn=True)
    jstate = JaxCompressed(jstate, JaxCompression(jax.tree.map(
        lambda p: jnp.zeros(p.shape, jnp.float32), jstate.params)))
    state = CompressedTrainState(state, optim.init_state(state.params))
    batch = next(_batches(cfg, 1))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, batch)
    assert sorted(m) == sorted(jm)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=PARAM_TOL)
    jerr = from_jax_params(cfg, jax.tree.map(np.asarray, jstate.comp.error))
    jpar = from_jax_params(cfg, jax.tree.map(np.asarray,
                                             jstate.inner.params))
    perr = {}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}.")
            else:
                perr[prefix + k] = v.numpy()
    flat(state.comp.error)
    params = dict(lm.named_parameters())
    flipped = total = 0
    for name, e in jerr.items():
        e = e.numpy()
        quantum = 2.0 * np.abs(e).max()        # ~ one int8 step
        # the buffer carries the gradient's float noise: 1e-5 x max|g|,
        # max|g| = 127 quanta
        diff = np.abs(perr[name] - e)
        flip = diff > PARAM_TOL * 127 * quantum
        assert (diff[flip] <= 1.01 * quantum).all(), name
        flipped += int(flip.sum())
        total += e.size
        w = jpar[name].numpy()
        pdiff = np.abs(params[name].detach().numpy() - w)
        assert (pdiff[~flip] <= PARAM_TOL * np.abs(w).max()).all(), name
        assert (pdiff[flip] <= 2 * lr).all(), name
    assert flipped <= 1e-3 * total, (flipped, total)


def _pipes(cfg, rows=2, seq=64, shards=(2,)):
    return [cls_p(cls_s(vocab_size=cfg.vocab_size, mean_len=48, max_len=seq,
                        seed=0), shard_dims=shards, rows_per_shard=rows,
                  seq_len=seq)
            for cls_s, cls_p in ((JaxDocStream, JaxPipeline),
                                 (DocStream, Pipeline))]


def test_train_loop_matches_jax(tmp_path):
    arch = "olmo-1b"
    cfg = REGISTRY[arch].smoke()
    jlm = JaxLM(cfg)
    jstate = jax_init_state(jlm, jopt.AdamW(weight_decay=0.01),
                            jax.random.key(0))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jdir, 0, jstate)
    lm, state = _from_jax(arch, jstate)
    save(pdir, 0, state)
    jpipe, pipe = _pipes(cfg)
    _, jhist = jax_train(jlm, jopt.AdamW(weight_decay=0.01),
                         jopt.warmup_cosine(3e-3, 5, 60), jpipe,
                         JaxLoopConfig(steps=5, ckpt_dir=jdir))
    _, hist = train(lm, AdamW(weight_decay=0.01), warmup_cosine(3e-3, 5, 60),
                    pipe, LoopConfig(steps=5, ckpt_dir=pdir))
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    assert sorted(hist[0]) == sorted(jhist[0])
    for got, want in zip(hist, jhist):
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOOP_RTOL)
    assert latest_step(pdir) == 5


# ---------------------------------------------------------------------------
# the reference's training cases, on the port
# ---------------------------------------------------------------------------

def _setup(name="olmo-1b", rows=2, seq=64, shards=(2,)):
    cfg = port_config(name).smoke()
    lm = LM(cfg, device="cpu")
    stream = DocStream(vocab_size=cfg.vocab_size, mean_len=48, max_len=seq,
                       seed=0)
    pipe = Pipeline(stream, shard_dims=shards, rows_per_shard=rows,
                    seq_len=seq)
    opt = AdamW(weight_decay=0.01)
    sch = warmup_cosine(3e-3, warmup_steps=5, total_steps=60)
    return cfg, lm, pipe, opt, sch


def test_loss_decreases_over_short_run():
    cfg, lm, pipe, opt, sch = _setup()
    loop = LoopConfig(steps=30, remat=False)
    state, hist = train(lm, opt, sch, pipe, loop)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    assert int(state.opt.step) == 30


def test_microbatched_matches_full_batch():
    cfg, lm, pipe, opt, sch = _setup()
    batch, _ = pipe.batch(0)
    lm2 = LM(cfg, device="cpu")
    s1 = init_state(lm, opt, torch.Generator().manual_seed(0))
    s2 = init_state(lm2, opt, torch.Generator().manual_seed(0))
    make_train_step(lm, opt, sch, remat=False, microbatches=1)(s1, batch)
    make_train_step(lm2, opt, sch, remat=False, microbatches=2)(s2, batch)
    diff = max(float((a - b).detach().abs().max()) for a, b in
               zip(lm.parameters(), lm2.parameters()))
    assert diff < 5e-3


def test_checkpoint_restart_resumes_identically(tmp_path):
    d = str(tmp_path / "ck")
    cfg, lm, pipe, opt, sch = _setup()
    loop = LoopConfig(steps=20, ckpt_dir=d, ckpt_every=10, remat=False)
    state_a, hist_a = train(lm, opt, sch, pipe, loop)
    params_a = [p.detach().clone() for p in lm.parameters()]
    assert latest_step(d) is not None
    for f in sorted(os.listdir(d)):
        if f.startswith("step_") and int(f.split("_")[1]) > 10:
            shutil.rmtree(os.path.join(d, f))
    cfg, lm_b, pipe, opt, sch = _setup()
    loop_b = LoopConfig(steps=20, ckpt_dir=d, ckpt_every=10, remat=False)
    state_b, hist_b = train(lm_b, opt, sch, pipe, loop_b)
    assert hist_b[0]["step"] == 10
    diff = max(float((a - b).detach().abs().max())
               for a, b in zip(params_a, lm_b.parameters()))
    assert diff < 1e-5
    np.testing.assert_allclose([h["loss"] for h in hist_b],
                               [h["loss"] for h in hist_a[10:]], rtol=1e-5)


def test_straggler_monitor_feeds_pipeline():
    cfg, lm, pipe, opt, sch = _setup(shards=(4,), rows=1)
    mon = StragglerMonitor(n_hosts=4)
    pipe.monitor = mon
    train(lm, opt, sch, pipe, LoopConfig(steps=3, remat=False), monitor=mon)
    assert np.isfinite(mon.powers()).all()


def test_moe_arch_trains():
    cfg, lm, pipe, opt, sch = _setup("granite-moe-1b-a400m")
    state, hist = train(lm, opt, sch, pipe, LoopConfig(steps=8, remat=False))
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert {"rebalanced", "overflow", "dropped"} <= set(hist[0])


def test_sigterm_stops_with_a_final_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    cfg, lm, pipe, opt, sch = _setup()

    def hook(step, row):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    loop = LoopConfig(steps=50, ckpt_dir=d, ckpt_every=100, log_every=1,
                      remat=False, metrics_hook=hook)
    state, hist = train(lm, opt, sch, pipe, loop)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert latest_step(d) == 3 == int(state.opt.step)


def test_compressed_step_tracks_uncompressed():
    cfg = port_config("olmo-1b").smoke()
    opt = AdamW(weight_decay=0.0)
    lm_p, lm_c = (LM(cfg, device="cpu") for _ in range(2))
    plain = make_train_step(lm_p, opt, constant(1e-3), remat=False)
    comp = make_train_step(lm_c, opt, constant(1e-3), remat=False,
                           compress_dcn=True)
    s_plain = init_state(lm_p, opt, torch.Generator().manual_seed(0))
    inner = init_state(lm_c, opt, torch.Generator().manual_seed(0))
    s_comp = CompressedTrainState(inner, CompressionState(error={
        k: v for k, v in optim.init_state(inner.params).error.items()}))
    rng = np.random.default_rng(100)
    losses_p, losses_c = [], []
    for _ in range(8):
        tokens = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        batch = {"tokens": tokens, "labels": tokens}
        s_plain, m_p = plain(s_plain, batch)
        s_comp, m_c = comp(s_comp, batch)
        losses_p.append(float(m_p["loss"]))
        losses_c.append(float(m_c["loss"]))
    diffs = np.abs(np.array(losses_p) - np.array(losses_c))
    assert diffs.max() < 0.05, (losses_p, losses_c)
    errs = jax.tree.leaves(jax.tree.map(lambda e: float(e.abs().max()),
                                        s_comp.comp.error))
    assert any(e > 0 for e in errs) and all(np.isfinite(errs))


def test_cli_prints_the_three_keys():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--smoke", "--device", "cpu", "--steps", "3"],
        env=env, check=True, capture_output=True, text=True, timeout=300)
    record = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(record) == ["final_loss", "final_step", "first_loss"]
    assert record["final_step"] == 3
    assert np.isfinite(record["first_loss"]) and np.isfinite(
        record["final_loss"])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_cli_refuses_a_mesh(mesh):
    """``--mesh`` trains sharded on a world of the production mesh's size
    (``tests/test_torch_sharded_ckpt.py`` runs it on a patched one); one
    process started without a launcher's rank environment is refused
    before any training."""
    with pytest.raises(ValueError, match="RANK"):
        train_cli.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                        "--mesh", mesh])
