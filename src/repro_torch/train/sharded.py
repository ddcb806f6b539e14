"""Training on a ``DeviceMesh``: the state as DTensor shards, placed by the
sharding plans (``launch.shardings.state_pspecs``), and what the train
step, the loop and the checkpoints do with them.

* State: each parameter of the LM becomes a DTensor of its local shard
  (param specs), each AdamW moment one of its own (moment specs, ZeRO-1
  across pods); the step counter stays a plain 0-d tensor. Drawn from a
  generator (``shard_state(..., generator)``, on an LM built with
  ``materialize=False``), the weights come one leaf at a time and a rank
  keeps its shard of each before the next is drawn, so it never holds
  more than one whole leaf beside its shards; the shards equal
  ``LM.init``'s weights cut up, bit for bit.
* Forward and backward: each rank takes its block of the batch's rows;
  along ``model`` the ranks split the compute of those rows
  (``launch.shardings.compute_split``: heads, ff columns, experts, Mamba
  channels, vocabulary columns), each on its weights' ``model`` shards.
  The LM gathers a sub-block's weights over the other mesh dims when it
  runs, and the gather's backward sums their gradients over the batch's
  ranks (``models.distributed``). A split leaf's gradient is this rank's
  part of the whole gradient, not a copy.
* Clipping: the global norm counts each element once — a rank adds a
  leaf's squares only where it is the first of the ranks holding that
  shard (a split leaf's ``model`` shards are parts: every model rank
  adds its own) — summed over the whole mesh.
* Metrics: the loss and its terms are whole on every ``model`` rank; they
  are summed over the batch's ranks alone.
* Update: AdamW on the local shards in place; a leaf whose moments are
  laid out otherwise than its parameter (widened over ``pod``) updates the
  moments' block and gathers the new values back into the parameter's.
* Checkpoints: ``save`` gathers one leaf at a time, which rank 0 writes
  as it arrives under the JAX package's npz keys; ``restore`` reads one
  leaf at a time on every rank and copies its block into the shards
  before reading the next. A rank holds one whole leaf at a time.

Every collective is skipped on a mesh dim of size 1, so a (1, 1) mesh
trains bit for bit as the unsharded step does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from ..checkpoint import ckpt
from ..launch.shardings import compute_split, placements, state_pspecs
from ..models.common import draws, param_tree
from ..models.distributed import (
    BatchGroup,
    ModelSplit,
    gather_full,
    local_chunk,
    to_local,
)
from ..optim.adamw import AdamW, AdamWState, tree_items, tree_map
from .state import TrainState

__all__ = ["Sharding", "shard_params", "shard_state", "gather_leaf",
           "save", "restore"]


def _dtensor(local, mesh, pl, shape, stride) -> DTensor:
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=stride)


class Sharding:
    """The layout of a TrainState on ``mesh``: per leaf (its key path) the
    parameter's and the moments' placements, the batch's ranks (the
    ``rules``' ``batch`` axes) and the compute's split over ``model``."""

    def __init__(self, lm, mesh, rules: dict):
        self.mesh = mesh
        self.batch = BatchGroup(mesh, rules.get("batch"))
        self.split = ModelSplit(mesh, compute_split(lm.cfg, mesh, rules))
        shapes = param_tree(lm)
        specs = state_pspecs(TrainState(shapes, AdamWState(None, shapes,
                                                           shapes)),
                             lm.cfg, mesh)
        self.param = {path: placements(mesh, s)
                      for path, s in tree_items(specs.params)}
        self.moment = {path: placements(mesh, s)
                       for path, s in tree_items(specs.opt.m)}

    def _owner(self, pl) -> bool:
        """Whether this rank is the first of those holding its shard."""
        return all(self.mesh.get_local_rank(i) == 0
                   for i, p in enumerate(pl) if isinstance(p, Replicate))

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        for i in range(self.mesh.ndim):
            if self.mesh.size(i) > 1:
                dist.all_reduce(t, group=self.mesh.get_group(i))
        return t

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient from the local shards ``grads``,
        each element counted once."""
        sq = [torch.sum(torch.square(g.float()))
              for path, g in tree_items(grads)
              if self._owner(self.param[path])]
        dev = next(iter(tree_items(grads)))[1].device
        total = (torch.sum(torch.stack(sq)) if sq
                 else torch.zeros((), device=dev))
        return torch.sqrt(self._sum(total))

    def reduce_metrics(self, metrics: dict) -> dict:
        """Every rank's share summed over the batch's ranks (the token
        count is the whole batch's already; over ``model`` each is whole
        already)."""
        return {k: v if k == "tokens" else self.batch.sum_(v.clone())
                for k, v in metrics.items()}

    @torch.no_grad()
    def update(self, optimizer: AdamW, grads, state: TrainState, lr):
        """AdamW on the local shards, in place. ``grads``: local shards in
        the parameters' placements."""
        widened = {}      # the moments' blocks of widened leaves
        for path, p in tree_items(state.params):
            if self.param[path] != self.moment[path]:
                full = gather_full(p.to_local(), self.mesh, self.param[path])
                widened[path] = local_chunk(full, self.mesh,
                                            self.moment[path]).clone()
        params = _rebuild(state.params, lambda path, p: widened.get(
            path, to_local(p)))
        grads = _rebuild(grads, lambda path, g: local_chunk(
            gather_full(g, self.mesh, self.param[path]), self.mesh,
            self.moment[path]) if path in widened else g)
        _, opt = optimizer.update(
            grads, AdamWState(state.opt.step, tree_map(to_local, state.opt.m),
                              tree_map(to_local, state.opt.v)), params, lr)
        for path, p in tree_items(state.params):
            if path in widened:
                full = gather_full(widened[path], self.mesh,
                                   self.moment[path])
                p.to_local().copy_(local_chunk(full, self.mesh,
                                               self.param[path]))
        return TrainState(state.params, AdamWState(opt.step, state.opt.m,
                                                   state.opt.v))


def _rebuild(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def shard_params(lm, mesh, rules: dict, generator=None) -> Sharding:
    """Turn the LM's parameters into DTensor shards in place and bind the
    batch group and the split to it; returns the Sharding. The values are
    the LM's own, or with ``generator`` drawn from it on ``lm.device`` one
    leaf at a time (``models.common.draws``: ``LM.init``'s values and
    order), each cut to this rank's shard before the next is drawn."""
    sharding = Sharding(lm, mesh, rules)
    values = (draws(lm, generator, lm.device) if generator is not None
              else [(n, p.detach()) for n, p in lm.named_parameters()])
    for name, value in values:
        p = lm.get_parameter(name)
        pl = sharding.param[tuple(name.split("."))]
        local = local_chunk(value, mesh, pl)
        if (local.shape != value.shape or local.dtype != p.dtype
                or not local.is_contiguous()):    # let the whole leaf go
            local = local.to(p.dtype, memory_format=torch.contiguous_format,
                             copy=True)
        del value
        owner, _, leaf = name.rpartition(".")
        setattr(lm.get_submodule(owner), leaf, nn.Parameter(
            _dtensor(local, mesh, pl, p.shape, p.stride()),
            requires_grad=p.requires_grad))
    lm.batch = sharding.batch
    lm.split = sharding.split
    lm._weights = None
    return sharding


def shard_state(lm, optimizer: AdamW, mesh, rules: dict, generator=None
                ) -> tuple[TrainState, Sharding]:
    """``shard_params`` (with ``generator``: the weights drawn), and AdamW
    started on sharded moments. Returns (TrainState, Sharding)."""
    sharding = shard_params(lm, mesh, rules, generator)

    def zeros(path, p):
        ml = sharding.moment[path]
        whole = torch.empty(p.shape, device="meta")
        return _dtensor(torch.zeros(local_chunk(whole, mesh, ml).shape,
                                    dtype=optimizer.moments_dtype,
                                    device=to_local(p).device),
                        mesh, ml, p.shape, whole.stride())
    params = param_tree(lm)
    return TrainState(params, AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        m=_rebuild(params, zeros), v=_rebuild(params, zeros))), sharding


def gather_leaf(t: torch.Tensor) -> torch.Tensor:
    """A DTensor made whole from every rank's shard (a collective); any
    other tensor as it is."""
    if isinstance(t, DTensor):
        return gather_full(t.to_local(), t.device_mesh, t.placements)
    return t


def save(directory: str, step: int, state: TrainState,
         metadata: dict | None = None, keep_last: int | None = None):
    """Checkpoint the sharded ``state`` (a collective: every rank calls
    it): one leaf at a time is gathered whole on every rank and rank 0
    writes it as it arrives (``checkpoint.ckpt.save``), under the JAX
    package's npz keys. Returns the directory on rank 0, None elsewhere."""
    return ckpt.save(directory, step, state, metadata, keep_last,
                     fetch=gather_leaf, write=dist.get_rank() == 0)


@torch.no_grad()
def _put(live: torch.Tensor, saved: torch.Tensor) -> torch.Tensor:
    if isinstance(live, DTensor):
        live.to_local().copy_(local_chunk(saved, live.device_mesh,
                                          live.placements))
        return live
    return saved.to(torch.int32).reshape(())       # the step


def restore(directory: str, state: TrainState):
    """Resume the sharded ``state`` from the latest checkpoint in
    ``directory``, re-sharding it as ``state`` is laid out: every rank
    reads one leaf at a time and copies its block into the shards before
    reading the next. Returns (step, TrainState, metadata)."""
    step, tree, metadata = ckpt.restore(directory, state, put=_put)
    return step, TrainState(state.params, AdamWState(
        step=tree.opt.step, m=state.opt.m, v=state.opt.v)), metadata
