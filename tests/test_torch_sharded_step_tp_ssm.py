"""``test_torch_sharded_step_tp.py``'s split step for the state-space
archs, falcon-mamba-7b and jamba-v0.1-52b smoke configs, on (4, 2), (2, 2,
2) and (2, 4) gloo meshes at its bounds (its docstring).

A checkpoint written by the split step (jamba on (2, 4): attention with
its KV projections whole, experts, Mamba channels, the vocabulary all
split) restores on the ranks bit for bit, shard by shard; it holds the
JAX layout (the keys, shapes and dtypes of the JAX package's own
checkpoint of its state), and every array, stage by stage, equals the
split step's state gathered whole, bit for bit.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import _torch_rank_fns as fns  # noqa: E402
import _torch_tp_fns as tp  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.models.convert import jax_key  # noqa: E402
from test_torch_sharded_step import _batch, _jax  # noqa: E402
from test_torch_sharded_step_tp import (  # noqa: E402
    _want_split,
    check_split_step,
)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_split_step_matches_one_process_and_jax(tmp_path, arch):
    check_split_step(tmp_path, arch)


def test_split_checkpoint_restores_bit_for_bit_in_the_jax_layout(tmp_path):
    arch = "jamba-v0.1-52b"
    cfg = get_config(arch).smoke()
    jlm, jparams = _jax(arch)
    state_dict = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    ckpt = tmp_path / "ckpt"
    ranks = run_ranks(tp.split_checkpoint, 8, tmp_path, arch, state_dict,
                      _batch(cfg), (2, 4), ("data", "model"), str(ckpt),
                      timeout=300)
    assert all(r["equal"] and r["step"] == 1 for r in ranks)
    assert ranks[0]["flags"] == _want_split(cfg, 4)

    # the JAX layout: the JAX package's own checkpoint of its state
    jdir = jckpt.save(str(tmp_path / "jax"), 1, jax_init_state(
        jlm, jopt.AdamW(), jax.random.key(0)))
    want = fns.npz_arrays(f"{jdir}/arrays.npz")
    got = fns.npz_arrays(ckpt / "step_0000000001" / "arrays.npz")
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].shape == arr.shape and got[key].dtype == arr.dtype

    # every array, stage by stage, is the split step's state gathered
    prefix = (".params", ".opt/.m", ".opt/.v")
    for (i, *path), leaf in ranks[0]["whole"].items():
        key, stacked = jax_key(".".join(path))
        arr = got[f"{prefix[i]}/{key}"]
        if stacked:
            arr = arr[int(path[1])]
        assert arr.dtype == leaf.dtype and np.array_equal(arr, leaf), path
    assert len(ranks[0]["whole"]) == 3 * len(state_dict)
