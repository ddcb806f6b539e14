"""The port's checkpoints on the CPU: the reference's checkpoint cases of
``tests/test_substrate.py`` (round trip, a mismatch raises, async writes
and pruning, corruption detected), training states of a smoke LM (stages
per module here, stacked in the file), and the file against the JAX
package's: a converted ``TrainState`` saved by the port gives the same
``arrays.npz`` keys, shapes, dtypes and per-leaf hashes as the JAX
package's save of the same state, and the JAX package's arrays restore into
the port's state."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.train import init_state as jax_init_state
from repro_torch.checkpoint import (
    Checkpointer,
    latest_step,
    restore,
    save,
)
from repro_torch.configs import get_config as port_config
from repro_torch.models import LM, from_jax_state
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import TrainState, init_state


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 7, _tree(), metadata={"note": "x"})
    assert latest_step(d) == 7
    step, tree, meta = restore(d, {"a": torch.zeros(2, 3), "b": {
        "c": torch.zeros(4, dtype=torch.int32)}})
    assert step == 7 and meta["note"] == "x"
    assert torch.equal(tree["a"], _tree()["a"])
    assert torch.equal(tree["b"]["c"], _tree()["b"]["c"])
    with open(os.path.join(d, "step_0000000007", "manifest.json")) as f:
        assert json.load(f)["keys"]["b/c"]["dtype"] == "int32"


def test_restore_validates_shape(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 1, _tree())
    bad = {"a": torch.zeros((3, 3)), "b": {"c": torch.zeros(
        (4,), dtype=torch.int32)}}
    with pytest.raises((ValueError, KeyError)):
        restore(d, bad)
    wrong_type = {"a": torch.zeros((2, 3), dtype=torch.float64),
                  "b": {"c": torch.zeros((4,), dtype=torch.int32)}}
    with pytest.raises(ValueError):
        restore(d, wrong_type)
    with pytest.raises(KeyError):
        restore(d, {**_tree(), "extra": torch.zeros(1)})


def test_async_checkpointer_and_prune(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, keep_last=2)
    for s in (1, 2, 3):
        ck.save_async(s, _tree())
    ck.wait()
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(steps) == 2
    assert latest_step(d) == 3
    assert not any(x.startswith("tmp.") for x in os.listdir(d))


def test_corruption_detected(tmp_path):
    d = str(tmp_path / "ck")
    path = save(d, 1, _tree())
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["a"] = data["a"] + 1  # silent bit-flip
    np.savez(npz, **data)
    with pytest.raises(ValueError, match="hash"):
        restore(d, _tree())
    step, tree, _ = restore(d, _tree(), validate=False)
    assert float(tree["a"][0, 0]) == 1.0


def test_bfloat16_leaves_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.randn(3, 5).to(torch.bfloat16)
    save(d, 2, {"m": x})
    _, tree, _ = restore(d, {"m": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert tree["m"].dtype == torch.bfloat16 and torch.equal(tree["m"], x)


def _port_state(arch, seed=0):
    lm = LM(port_config(arch).smoke(), device="cpu")
    return lm, init_state(lm, AdamW(), torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_train_state_roundtrip(tmp_path, arch):
    d = str(tmp_path / "ck")
    lm, state = _port_state(arch)
    with torch.no_grad():
        for i, m in enumerate(tree_leaves(state.opt.m)):
            m.fill_(i)
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(5, dtype=torch.int32)))
    save(d, 5, state)
    _, fresh = _port_state(arch, seed=1)
    step, got, _ = restore(d, fresh)
    assert step == 5 and int(got.opt.step) == 5
    assert isinstance(got, TrainState)
    for a, b in zip(tree_leaves(got.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(got.opt.m), tree_leaves(state.opt.m)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "falcon-mamba-7b"])
def test_npz_equals_the_jax_packages(tmp_path, arch):
    cfg = get_config(arch).smoke()
    jstate = jax_init_state(JaxLM(cfg), JaxAdamW(), jax.random.key(3))
    # non-zero moments and step, so every leaf's hash says something
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.int32(4),
        m=jax.tree.map(lambda x: x * 0.5 + 1, jstate.params),
        v=jax.tree.map(lambda x: x * x, jstate.params)))
    jdir = jckpt.save(str(tmp_path / "jax"), 4, jstate)
    np_state = jax.tree.map(np.asarray, jstate)
    state_dict, opt = from_jax_state(cfg, np_state)
    lm = LM(port_config(arch).smoke(), device="cpu")
    lm.load_state_dict(state_dict)
    base = init_state(lm, AdamW())
    pdir = save(str(tmp_path / "port"), 4, TrainState(base.params, opt))
    jnpz = np.load(os.path.join(jdir, "arrays.npz"))
    pnpz = np.load(os.path.join(pdir, "arrays.npz"))
    assert sorted(jnpz.files) == sorted(pnpz.files)
    for key in jnpz.files:
        a, b = jnpz[key], pnpz[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert a.tobytes() == b.tobytes(), key
    with open(os.path.join(pdir, "manifest.json")) as f:
        pman = json.load(f)
    for key, meta in pman["keys"].items():
        assert meta["hash"] == jckpt.ckpt._leaf_hash(jnpz[key]), key
    # and the JAX package's arrays restore into the port's state
    _, fresh = _port_state(arch, seed=9)
    _, got, _ = restore(str(tmp_path / "port"), fresh)
    for a, b in zip(tree_leaves(got.params), tree_leaves(base.params)):
        assert torch.equal(a, b)
