"""The train step: loss -> grads (optionally microbatched) -> [optional int8
DCN compression] -> clip -> AdamW update, in place on the LM's parameters.
The reference's step (``src/repro/train/step.py``) case for case, run
eagerly: autograd for ``jax.value_and_grad``, a Python loop over the
microbatches for its ``lax.scan``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.distributed import to_local
from ..optim.adamw import AdamW, clip_by_global_norm, tree_leaves, tree_map
from ..optim.compress import CompressionState, compress_tree, decompress
from .state import TrainState

__all__ = ["make_train_step", "CompressedTrainState"]


class CompressedTrainState(NamedTuple):
    """TrainState + the error-feedback buffers of DCN grad compression."""
    inner: TrainState
    comp: CompressionState


def make_train_step(lm, optimizer: AdamW, lr_schedule, *, remat: bool = True,
                    clip_norm: float = 1.0, microbatches: int = 1,
                    compress_dcn: bool = False, sharding=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"tokens": (B, S), "labels": (B, S), optional "prefix_embed"},
    tensors or arrays. ``state.params`` must be ``lm``'s parameters
    (``init_state``); they and the moments are updated in place. With
    ``microbatches > 1`` the batch splits along axis 0 and gradients
    accumulate in float32, each divided by ``microbatches``; the metrics are
    the last microbatch's.

    ``compress_dcn=True`` passes gradients through int8 symmetric
    quantisation with error feedback before the optimizer, one scale per
    JAX-layout leaf (``compress_tree``); the state is then a
    ``CompressedTrainState`` carrying the EF buffers.

    ``sharding`` (``train.sharded.Sharding``, with the state from
    ``shard_state``): the step of a mesh. The batch is the global one; each
    rank takes its rows, the gradients are its shards of the whole batch's,
    the norm counts every element once, the update runs on the shards, and
    the metrics are the whole batch's. Not with ``compress_dcn``.

    The step's ``loss_grads(params, batch)`` gives (loss, metrics,
    gradients) alone, without the update (on a mesh: this rank's loss
    share and gradient shards)."""
    if sharding is not None and compress_dcn:
        raise ValueError("compress_dcn is not implemented on a mesh")

    def as_tensor(x):
        x = torch.as_tensor(x, device=lm.device)
        return x if sharding is None else sharding.batch.rows(x)

    def grads_of(params, batch):
        tensors = tree_leaves(params)
        loss, metrics = lm.loss(batch, remat=remat)
        # a parameter the batch does not reach (prefix_proj without a
        # prefix) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        by_id = {id(p): g for p, g in zip(tensors, grads)}
        tree = tree_map(lambda p: torch.zeros_like(p) if by_id[id(p)] is None
                        else by_id[id(p)], params)
        if sharding is not None:
            tree = tree_map(to_local, tree)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            tree

    def accumulate(params, batch):
        for x in batch.values():
            assert x.shape[0] % microbatches == 0, (x.shape[0], microbatches)
        acc = tree_map(lambda p: torch.zeros(to_local(p).shape,
                                             dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=lm.device)
        metrics = {}
        for i in range(microbatches):
            mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                               *x.shape[1:])[i] for k, x in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            acc = tree_map(lambda a, g: a + g.float() / microbatches, acc,
                           grads)
            loss_acc = loss_acc + loss / microbatches
        return loss_acc, metrics, acc

    def loss_grads(params, batch):
        batch = {k: as_tensor(v) for k, v in batch.items()}
        if microbatches > 1:
            return accumulate(params, batch)
        return grads_of(params, batch)

    def _core(state: TrainState, grads, loss, metrics):
        if sharding is None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            grads, gnorm = clip_by_global_norm(
                grads, clip_norm, norm=sharding.global_norm(grads))
            metrics = sharding.reduce_metrics({**metrics, "loss": loss})
            loss = metrics.pop("loss")
        lr = lr_schedule(state.opt.step)
        if sharding is None:
            state = TrainState(*optimizer.update(grads, state.opt,
                                                 state.params, lr))
        else:
            state = sharding.update(optimizer, grads, state, lr)
        metrics = {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr}
        return state, metrics

    def train_step(state: TrainState, batch):
        loss, metrics, grads = loss_grads(state.params, batch)
        return _core(state, grads, loss, metrics)

    def train_step_compressed(state: CompressedTrainState, batch):
        inner = state.inner
        loss, metrics, grads = loss_grads(inner.params, batch)

        corrected = tree_map(lambda g, e: g.float() + e, grads,
                             state.comp.error)
        deq = tree_map(decompress, *compress_tree(corrected))
        errs = tree_map(lambda c, d: c - d, corrected, deq)
        grads = deq
        new_inner, metrics = _core(inner, grads, loss, metrics)
        return (CompressedTrainState(new_inner, CompressionState(errs)),
                metrics)

    step = train_step_compressed if compress_dcn else train_step
    step.loss_grads = loss_grads
    return step

