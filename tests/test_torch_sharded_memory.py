"""A rank's memory on the sharded path: 8 gloo ranks on the production mesh
patched to (4, 2) ``("data", "model")``, olmo-1b's smoke config at 4
and 8 layers, the LM built with ``materialize=False``.

Each rank counts the bytes of the tensors it makes and still holds after
every op (``_torch_rank_fns.LiveBytes``: an op's new storages, until they
are freed; collectives included), and the Python heap's growth
(tracemalloc: numpy arrays and bytes on the host). Bounds, per rank:
  * drawing the weights (``shard_state`` with a generator) peaks at the
    rank's state shards (params, m, v) plus at most two whole leaves, and
    the shards equal ``LM.init``'s weights cut up, bit for bit;
  * a checkpoint's save holds at most three whole leaves in tensors at a
    time (the gather's parts, their concatenation, the host copy) and one
    on the Python heap; its restore two on the heap (the leaf read in
    place, and the manifest and the tree's keys) and no tensor but the
    step counter; the restored shards equal the saved ones;
  * one step's forward and backward stay under the gradient shards it
    returns plus two whole stages and two copies of the weights outside
    the stages, and doubling the depth adds no more than the new stages'
    gradient shards plus one stage: the stages are gathered one at a time.
Each bound is smaller than the whole model's float32 bytes, so a rank that
held the model whole would fail it.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import torch

import _torch_rank_fns as fns
from _torch_ranks import run_ranks

ARCH = "olmo-1b"
DEPTHS = (4, 8)


def _batch():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 500, (8, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


def test_a_rank_holds_its_shards_and_one_leaf_or_stage_at_a_time(tmp_path):
    ranks = run_ranks(fns.sharded_memory, 8, tmp_path, ARCH, DEPTHS,
                      str(tmp_path / "ckpt"), _batch(), timeout=180)
    for rank, out in enumerate(ranks):
        for depth, r in out.items():
            where = f"rank {rank}, {depth} layers: {r}"
            leaf, stage = r["largest_leaf"], r["largest_stage"]
            outside = r["outside"]
            assert r["init_equal"] and r["restored"], where

            init = r["init"]["end"] + 2 * leaf
            assert r["init"]["peak"] <= init < r["whole"], where
            assert r["shard_bytes"] < r["whole"] / 4, where

            assert r["save"]["peak"] <= 3 * leaf < r["whole"], where
            assert r["save"]["host"] <= leaf, where
            assert r["restore"]["peak"] <= 4, where     # the step counter
            assert r["restore"]["host"] <= 2 * leaf, where

            grads = r["loss_grads"]
            bound = grads["end"] + 2 * stage + 2 * outside
            assert grads["peak"] <= bound < r["whole"], where
        shallow, deep = out[DEPTHS[0]], out[DEPTHS[1]]
        added = deep["loss_grads"]["end"] - shallow["loss_grads"]["end"]
        assert (deep["loss_grads"]["peak"] - shallow["loss_grads"]["peak"]
                <= added + shallow["largest_stage"]), (rank, out)
