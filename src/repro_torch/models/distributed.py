"""The model's side of a sharded step: weights gathered at use, the
tensor-parallel split over ``model``, and sums over the ranks a batch is
split across.

A sharded LM holds each parameter as a ``DTensor`` of its local shard
(``train.sharded``). ``gathered`` makes a (sub)tree of them whole over the
mesh dims the step does not split its compute on when a layer runs — and
again when a remat recompute runs it — so a rank holds one stage's weights
at a time beside its shards.

Along ``model`` the train step computes each rank's part (``ModelSplit``,
read from ``launch.shardings.compute_split``): a leaf the split computes on
keeps its ``model`` shard (its query heads, ff columns, experts,
vocabulary rows, Mamba channels), inside Megatron-style column- and
row-parallel products: a replicated activation enters the split through
``copy_to`` (identity forward, all-reduce backward) and partial sums leave
it through ``reduce_from`` (all-reduce forward, identity backward), so
every replicated activation and its gradient are whole and equal on every
model rank. Every other leaf is gathered whole.

The gather's backward sums the gradient over the batch's mesh dims and
keeps this rank's shard (``sum_shard``): a reduce-scatter where the leaf is
sharded over a batch dim (FSDP), an all-reduce where it is replicated over
one. Over ``model`` a gradient is one of three kinds, which each layer
declares for its leaves (its ``split_modes``): a split leaf's is this
rank's part and stays (``LOCAL``); a leaf computed whole on every model
rank has a copy of the whole gradient there, which is cut, not summed
(``WHOLE``); a leaf gathered whole of which the rank uses its own columns
alone (``columns``: Mamba's ``in_proj`` columns of its channels, the KV
projections' columns of its query heads' groups where the KV heads do not
split, the untied unembedding's columns of its vocabulary block: the plans
cut ``in_proj`` into blocks that do not follow the channels and the
unembedding along d, as the JAX package's do) has parts, which are summed
(``PARTS``). Kernels only ever see plain tensors.

Serving splits the same way over ``model`` (``LM.prefill`` /
``decode_step``, under ``no_grad``), and each rank holds its block of the
cache (``SeqSplit``): the KV cache's sequence cut over the mesh dims
``launch.shardings.cache_split`` reads from the plans. Decode attends each
block apart and merges the partial softmaxes over the sequence's ranks
(``merge_softmax``: the max all-reduced first, then the rescaled sums).

Along ``expert`` (the ``ep`` meshes of ``launch.mesh``, where the plans
lay the experts' dim) each rank holds and runs its own experts,
``[r E/ep, (r + 1) E/ep)`` (``ModelSplit.ep``): the experts' weights are
gathered over every other dim but kept local over ``expert``
(``EXPERT``), and their gradient is not summed over it: it is already the
gradient of the rank's experts over every token that reached them. Where
the batch's rows are split over ``expert`` the tokens move, as GShard
moves them: each rank's slot tensor (G, E, C, d) is cut along E into ep
blocks sent to their owners (``to_experts``, an all-to-all; backward: the
inverse all-to-all), the experts run on (ep G, E/ep, C, d), and the
results go back the same way (``from_experts``). Where the rows are not
split over ``expert`` (a serve batch that does not divide), no token
moves: each rank runs its experts on every row and its partial combine is
summed over ``expert`` (``expert_sum``), as the experts over ``model`` are.

Each collective runs on the process group of one mesh dim and is skipped
where that dim has size 1, and a model axis of size 1 splits nothing (nor
does an expert axis of size 1), so a (1, 1) mesh computes what the
unsharded LM does, bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

__all__ = ["BatchGroup", "ModelSplit", "SeqSplit", "LOCAL", "WHOLE",
           "PARTS", "EXPERT", "columns", "merge_softmax", "merge_blocks",
           "map_cache", "to_local", "local_chunk", "gather_full",
           "sum_shard", "gathered", "all_to_all"]

LOCAL, WHOLE, PARTS, EXPERT = "local", "whole", "parts", "expert"


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


class _CopyTo(torch.autograd.Function):
    """Identity; backward: the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the group; backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """Every rank's block along ``dim``, concatenated in rank order;
    backward: this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(group.size())]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


class _AllToAll(torch.autograd.Function):
    """Block i of dim 0 sent to rank i of the group, block i of the result
    received from it; backward: the same exchange of the gradient (its
    inverse: the blocks are equal)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s dim 0 cut into ``group.size()`` equal blocks, block i sent
    to the group's rank i; the result's block i is rank i's block for this
    rank (differentiable)."""
    return _AllToAll.apply(x, group)


def _axis(mesh, name: str):
    """(size, this rank's index, process group or None) of a mesh dim;
    (1, 0, None) where the mesh lacks it."""
    names = list(mesh.mesh_dim_names)
    if name not in names:
        return 1, 0, None
    dim = names.index(name)
    size = mesh.size(dim)
    return (size, mesh.get_local_rank(dim),
            None if size == 1 else mesh.get_group(dim))


class ModelSplit:
    """The train step's split over the mesh's ``model`` axis: the flags of
    ``launch.shardings.compute_split`` (``heads``, ``kv_heads``, ``ff``,
    ``vocab``, ``experts``, ``moe_ff``, ``inner``) and this rank's place on
    the axis, with the collectives that the split products need; and
    ``ep``, the experts laid over the ``expert`` axis, with this rank's
    place there and whether the batch's ``rows`` are split over it (the
    tokens move to their experts: ``moves``). With a model axis of size 1
    every ``model`` flag is False and nothing is split over it; with an
    expert axis of size 1 (or none) ``ep`` is False."""

    KEYS = ("heads", "kv_heads", "ff", "vocab", "experts", "moe_ff",
            "inner", "ep")

    def __init__(self, mesh, flags: dict, rows=()):
        names = list(mesh.mesh_dim_names)
        self.dim = names.index("model") if "model" in names else None
        self.size, self.rank, self.group = _axis(mesh, "model")
        self.ep_size, self.ep_rank, self.ep_group = _axis(mesh, "expert")
        for key in self.KEYS:
            setattr(self, key, bool(flags.get(key)) and (
                self.ep_size if key == "ep" else self.size) > 1)
        self.moves = self.ep and "expert" in tuple(rows or ())

    def flags(self) -> dict[str, bool]:
        """What is split, by ``KEYS``."""
        return {key: getattr(self, key) for key in self.KEYS}

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated activation entering the split (its gradient there
        is this rank's part: summed over ``model``)."""
        return _CopyTo.apply(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's partial sum leaving the split, summed over
        ``model``."""
        return _ReduceFrom.apply(x, self.group)

    def gather_from(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's block of ``x`` along ``dim``, whole."""
        return _GatherFrom.apply(x, dim % x.dim(), self.group, self.rank)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ``model``, cut from autograd."""
        x = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def block(self, n: int) -> int:
        """The first index of this rank's block of ``n`` local items (its
        block of ``n * size``)."""
        return self.rank * n

    def spans(self, width: int, parts: int = 1) -> list[tuple[int, int]]:
        """This rank's block of each of ``parts`` equal parts of ``width``
        columns, as ``columns`` takes them."""
        part = width // parts
        n = part // self.size
        return [(k * part + self.block(n), n) for k in range(parts)]

    def to_experts(self, x: torch.Tensor) -> torch.Tensor:
        """A slot tensor (G, E, C, ...) of this rank's groups over every
        expert -> (ep G, E/ep, C, ...) of every ``expert`` rank's groups
        over this rank's experts (rank i's groups in block i): one
        all-to-all over ``expert``."""
        g, e = x.shape[:2]
        n = e // self.ep_size
        blocks = x.reshape(g, self.ep_size, n, *x.shape[2:]).transpose(0, 1)
        return all_to_all(blocks, self.ep_group).reshape(
            self.ep_size * g, n, *x.shape[2:])

    def from_experts(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse of ``to_experts``: (ep G, E/ep, C, ...) -> (G, E,
        C, ...), each group's slots back on the rank that holds its
        rows."""
        g, n = y.shape[0] // self.ep_size, y.shape[1]
        back = all_to_all(y.reshape(self.ep_size, g, n, *y.shape[2:]),
                          self.ep_group)
        return back.transpose(0, 1).reshape(g, self.ep_size * n,
                                            *y.shape[2:])

    def expert_copy(self, x: torch.Tensor) -> torch.Tensor:
        """``copy_to`` over ``expert``: rows every expert rank holds
        entering its experts (no token moves)."""
        return _CopyTo.apply(x, self.ep_group)

    def expert_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``reduce_from`` over ``expert``: the partial combine of this
        rank's experts summed over the expert ranks."""
        return _ReduceFrom.apply(x, self.ep_group)


def merge_softmax(m, s, o, amax, add):
    """Attention over several blocks of keys from each block's partial
    softmax: ``m`` (..., ) the block's max logit, ``s`` the sum of
    ``exp(logit - m)`` and ``o`` (..., hd) the values weighed by them.
    ``amax`` and ``add`` reduce over the blocks (a collective, or a sum
    over a stacked dim): each block is rescaled to the max over all blocks
    (a block wholly masked, every logit at the mask value, weighs
    ``exp(mask - max) = 0`` there, whatever its own sums), then the
    values' sum is divided by the weights' (both summed in one reduction).
    Returns (..., hd) float32."""
    top = amax(m)
    scale = torch.exp(m - top)
    both = add(torch.cat([o * scale[..., None], (s * scale)[..., None]],
                         dim=-1))
    return both[..., :-1] / both[..., -1:]


def merge_blocks(m, s, o) -> torch.Tensor:
    """``merge_softmax`` of blocks stacked on dim 0, on one device."""
    return merge_softmax(m, s, o, lambda t: t.amax(0, keepdim=True),
                         lambda t: t.sum(0))


class SeqSplit:
    """The KV cache's sequence split in serving: the mesh dims that cut
    the cache's sequence (``launch.shardings.cache_split``: ``model``, or
    ``("data", "model")`` where the batch does not split), flattened in
    mesh order, and this rank's block ``[lo, lo + block)`` of ``max_len``.
    A reduction over the flattened group is one over each of its dims in
    turn; a dim of size 1 issues none, so on one rank (``size`` 1) decode
    attends the whole cache as without a mesh."""

    def __init__(self, mesh, axes, max_len: int):
        names = list(mesh.mesh_dim_names)
        self.axes = tuple(axes)
        sizes = [mesh.size(names.index(a)) for a in self.axes]
        self.size = math.prod(sizes)
        index = 0
        for a, n in zip(self.axes, sizes):
            index = index * n + mesh.get_local_rank(a)
        self.groups = [mesh.get_group(a) for a, n in zip(self.axes, sizes)
                       if n > 1]
        if max_len % self.size:
            raise ValueError(f"a cache of {max_len} positions does not "
                             f"split over {self.size} ranks")
        self.max_len = max_len
        self.block = max_len // self.size
        self.lo = index * self.block

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = t.contiguous()
        for group in self.groups:
            dist.all_reduce(t, op=op, group=group)
        return t

    def merge_softmax(self, m, s, o) -> torch.Tensor:
        """The attention over the whole cache from this rank's partial
        softmax over its block (``merge_softmax``): the max all-reduced
        first, then the rescaled sums, two all-reduces a dim (no
        autograd: serving only)."""
        return merge_softmax(
            m, s, o, lambda t: self._reduce(t.clone(), dist.ReduceOp.MAX),
            lambda t: self._reduce(t, dist.ReduceOp.SUM))


def columns(w: torch.Tensor, spans) -> torch.Tensor:
    """The columns (last dim) of ``w`` in ``spans``, (first, count) pairs,
    in order: the part of a weight gathered whole (``PARTS``) that a rank
    computes with."""
    cut = [w[..., lo:lo + n] for lo, n in spans]
    return cut[0] if len(cut) == 1 else torch.cat(cut, dim=-1)


def map_cache(fn, tree, *rest):
    """``fn`` over the tensors of a serving cache (a ``KVCache`` or
    ``SSMCache``, or a dict of them) and of trees laid out as it is (its
    specs, its placements), in the cache's layout."""
    if isinstance(tree, dict):
        return {k: map_cache(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return type(tree)(*(fn(*xs) for xs in zip(tree, *rest)))


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


def gather_full(local: torch.Tensor, mesh, placements,
                skip: tuple = ()) -> torch.Tensor:
    """The whole tensor from every rank's shard ``local`` (the inverse of
    :func:`local_chunk`; no autograd); over the mesh dims in ``skip`` it
    stays this rank's shard."""
    t = local
    for i in reversed(range(len(placements))):
        p = placements[i]
        if isinstance(p, Shard) and mesh.size(i) > 1 and i not in skip:
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


def sum_shard(g: torch.Tensor, mesh, placements, axes,
              skip: tuple = ()) -> torch.Tensor:
    """This rank's shard (under ``placements``) of ``g`` summed over the
    mesh dims named in ``axes``, mesh dims in order: a reduce-scatter on
    such a dim that shards the tensor, an all-reduce on one that
    replicates it, a cut on any other (its ranks hold copies); ``g`` is
    already this rank's shard over the mesh dims in ``skip``. ``g`` is
    left as it is."""
    t = g
    for i, p in enumerate(placements):
        n = mesh.size(i)
        if n == 1 or i in skip:
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
    """DTensor shard -> the tensor whole over every mesh dim but those in
    ``skip``; backward: this rank's shard of the gradient summed over the
    batch's ranks and the mesh dims named in ``summed``."""

    @staticmethod
    def forward(ctx, dt, batch, skip, summed):
        ctx.meta = (dt.device_mesh, dt.placements, dt.shape, dt.stride())
        ctx.axes = tuple(batch.axes) + summed
        ctx.skip = skip
        return gather_full(dt.to_local(), dt.device_mesh, dt.placements,
                           skip)

    @staticmethod
    def backward(ctx, g):
        mesh, placements, shape, stride = ctx.meta
        local = sum_shard(g, mesh, placements, ctx.axes, ctx.skip)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=shape, stride=stride), None, None, \
            None


def gathered(tree, batch: BatchGroup, modes=WHOLE, path: tuple = ()):
    """``tree`` (nested dicts) with every DTensor leaf gathered as the step
    uses it: ``modes`` mirrors the tree, a mode (``LOCAL``, ``WHOLE``,
    ``PARTS`` or ``EXPERT``, see the module docstring; a tuple of modes
    for a leaf local over both ``expert`` and ``model``) standing for
    every leaf below it and a key it lacks for ``WHOLE``; other leaves as
    they are."""
    if isinstance(tree, dict):
        leaf_mode = isinstance(modes, (str, tuple))
        return {k: gathered(v, batch, modes if leaf_mode
                            else modes.get(k, WHOLE), path + (k,))
                for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    modes = (modes,) if isinstance(modes, str) else modes
    names = list(tree.device_mesh.mesh_dim_names)
    skip, summed = [], ()
    for mode, axis in ((LOCAL, "model"), (EXPERT, "expert")):
        if mode in modes:
            dim = names.index(axis)
            if not isinstance(tree.placements[dim], Shard):
                raise ValueError(f"{'.'.join(path)}: computed split over "
                                 f"{axis} but placed {tree.placements}")
            skip.append(dim)
    skip = tuple(skip)
    if PARTS in modes:
        summed = ("model",)
    if torch.is_grad_enabled() and tree.requires_grad:
        return _Gather.apply(tree, batch, skip, summed)
    return gather_full(tree.to_local(), tree.device_mesh, tree.placements,
                       skip)
