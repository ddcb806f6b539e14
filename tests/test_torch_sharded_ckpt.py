"""``launch.train --mesh single`` on 8 gloo ranks, the production mesh
patched to (4, 2) as ``tests/test_sharding_dryrun.py`` patches the JAX
package's: a sharded run of 4 steps checkpointed at step 2 and resumed
equals the uninterrupted sharded run bit for bit (every loss, every array
of the step-4 checkpoint), and the checkpoint rank 0 writes from the
gathered shards has the JAX package's npz keys, shapes and dtypes."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import numpy as np  # noqa: E402

import _torch_rank_fns as fns  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402

ARCH = "olmo-1b"


def _cli(tmp_path, ckpt_dir, steps, every):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh",
            "single", "--steps", str(steps), "--rows", "2", "--shards", "2",
            "--seq-len", "32", "--warmup", "1", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", str(every), "--log-every", "1"]
    ranks = run_ranks(fns.train_cli, 8, tmp_path, argv, timeout=180)
    assert all(r == ranks[0] for r in ranks)   # every rank saw one loss
    return ranks[0]


def test_sharded_restart_is_bit_exact_with_the_reference_keys(tmp_path):
    whole = _cli(tmp_path, tmp_path / "whole", 4, 100)
    first = _cli(tmp_path, tmp_path / "split", 2, 2)
    second = _cli(tmp_path, tmp_path / "split", 4, 2)
    assert whole["line"]["final_step"] == second["line"]["final_step"] == 4
    assert first["losses"] == whole["losses"][:2]
    assert second["losses"] == whole["losses"][2:]
    a = fns.npz_arrays(tmp_path / "whole" / "step_0000000004" /
                       "arrays.npz")
    b = fns.npz_arrays(tmp_path / "split" / "step_0000000004" /
                       "arrays.npz")
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key],
                                                               b[key]), key

    cfg = JAX_REGISTRY[ARCH].smoke()
    jstate = jax_init_state(JaxLM(cfg), jopt.AdamW(), jax.random.key(0))
    jdir = jckpt.save(str(tmp_path / "jax"), 4, jstate)
    want = fns.npz_arrays(f"{jdir}/arrays.npz")
    assert sorted(a) == sorted(want)
    for key, arr in want.items():
        assert a[key].shape == arr.shape and a[key].dtype == arr.dtype, key
