"""The model's side of a sharded step: weights gathered at use, and sums
over the ranks a batch is split across.

A sharded LM holds each parameter as a ``DTensor`` of its local shard
(``train.sharded``). ``gathered`` makes a (sub)tree of them whole when a
layer runs — and again when a remat recompute runs it — so a rank holds
one stage's full weights at a time beside its shards. Its backward sums
the gradient over the batch's mesh dims and keeps this rank's shard
(``sum_shard``): a reduce-scatter where the leaf is sharded over a batch
dim (FSDP), an all-reduce where it is replicated over one; model-axis
ranks compute the same rows, so their gradients are copies, not parts,
and are cut, not summed. Kernels only ever see the gathered plain
tensors.

Each collective runs on the process group of one mesh dim and is skipped
where that dim has size 1, so a (1, 1) mesh computes what the unsharded LM
does, bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

__all__ = ["BatchGroup", "to_local", "local_chunk", "gather_full",
           "sum_shard", "gathered"]


class BatchGroup:
    """The mesh dims a batch's rows are split over (the activation rules'
    ``batch`` axes, in mesh order, so the first is the major one)."""

    def __init__(self, mesh, axes):
        self.mesh = mesh
        self.axes = tuple(axes or ())
        names = list(mesh.mesh_dim_names)
        self.sizes = [mesh.size(names.index(a)) for a in self.axes]
        self.ranks = math.prod(self.sizes)
        index = 0
        for a, n in zip(self.axes, self.sizes):
            index = index * n + mesh.get_local_rank(a)
        self.index = index

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sums ``t`` in place over the batch's ranks (no autograd)."""
        for a, n in zip(self.axes, self.sizes):
            if n > 1:
                dist.all_reduce(t, group=self.mesh.get_group(a))
        return t

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the rows (axis 0) of a global batch."""
        if t.shape[0] % self.ranks:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split "
                             f"over {self.ranks} ranks")
        n = t.shape[0] // self.ranks
        return t[self.index * n:(self.index + 1) * n]


def to_local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage); a tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (mesh dims in
    order, so a tensor dim split by two mesh dims is split by the first
    one first)."""
    t = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return t


def gather_full(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor from every rank's shard ``local`` (the inverse of
    :func:`local_chunk`; no autograd)."""
    t = local
    for i in reversed(range(len(placements))):
        p = placements[i]
        if isinstance(p, Shard) and mesh.size(i) > 1:
            parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(i))
            t = torch.cat(parts, dim=p.dim)
    return t


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of ``t`` summed over ``group``."""
    n = group.size()
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def sum_shard(g: torch.Tensor, mesh, placements, axes) -> torch.Tensor:
    """This rank's shard (under ``placements``) of ``g`` summed over the
    mesh dims named in ``axes``, mesh dims in order: a reduce-scatter on
    such a dim that shards the tensor, an all-reduce on one that
    replicates it, a cut on any other (its ranks hold copies). ``g`` is
    left as it is."""
    t = g
    for i, p in enumerate(placements):
        n = mesh.size(i)
        if n == 1:
            continue
        summed = mesh.mesh_dim_names[i] in axes
        if isinstance(p, Shard) and summed and t.shape[p.dim] % n == 0:
            t = _reduce_scatter(t, p.dim, mesh.get_group(i))
            continue
        if summed:
            t = t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(t, group=mesh.get_group(i))
        if isinstance(p, Shard):
            t = t.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return t.contiguous()


class _Gather(torch.autograd.Function):
    """DTensor shard -> the whole tensor; backward: this rank's shard of
    the gradient summed over the batch's ranks."""

    @staticmethod
    def forward(ctx, dt, batch):
        ctx.meta = (dt.device_mesh, dt.placements, dt.shape, dt.stride())
        ctx.batch = batch
        return gather_full(dt.to_local(), dt.device_mesh, dt.placements)

    @staticmethod
    def backward(ctx, g):
        mesh, placements, shape, stride = ctx.meta
        local = sum_shard(g, mesh, placements, ctx.batch.axes)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=shape, stride=stride), None


def gathered(tree, batch: BatchGroup):
    """``tree`` (nested dicts) with every DTensor leaf whole (see the
    module docstring); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gathered(v, batch) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        if torch.is_grad_enabled() and tree.requires_grad:
            return _Gather.apply(tree, batch)
        return gather_full(tree.to_local(), tree.device_mesh,
                           tree.placements)
    return tree
