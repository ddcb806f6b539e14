"""Rank functions of the expert-parallel tests (run by
``_torch_ranks.run_ranks``, one per gloo rank; no JAX): the split train
step on ``ep`` meshes, watched op by op for its collectives and for the
experts' weights a rank holds, and the all-to-all against a gathered
reference."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import _torch_rank_fns as fns


class ExpertWatch(TorchDispatchMode):
    """What a rank does while it is on: every collective (kind, the mesh
    dim it runs over, its first written tensor's shape), and the largest
    3-D tensor with the model width in dim 1 or 2 that any op makes, in
    elements: the experts' weights ((experts, d, ff), (experts, ff, d)),
    their gradients and the activations (rows, S, d) are such tensors, so
    a rank that held more experts than its own would make a larger one.
    The mesh dim of a collective is read from its group's ranks: on a mesh
    of ``shape`` over the whole world, a dim's groups step by the product
    of the later dims' sizes."""

    def __init__(self, shape, axes, d_model: int):
        super().__init__()
        from repro_torch.launch.dryrun import _KINDS
        self.kinds, self.d = _KINDS, d_model
        self.stride = {int(np.prod(shape[i + 1:])): a
                       for i, a in enumerate(axes) if shape[i] > 1}
        self.collectives: list = []
        self.largest = 0

    def _axis(self, pg):
        ranks = dist.get_process_group_ranks(pg)
        return self.stride.get(ranks[1] - ranks[0]) if len(ranks) > 1 \
            else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            group = [a for a in args if isinstance(a, torch.ScriptObject)]
            pg = dist.ProcessGroup.unbox(group[0])
            first = args[0]
            while isinstance(first, (list, tuple)):
                first = first[0]
            self.collectives.append((self.kinds.get(func._opname,
                                                    func._opname),
                                     self._axis(pg), tuple(first.shape)))
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.dim() == 3
                    and self.d in t.shape[1:]):
                self.largest = max(self.largest, t.numel())
        return out

    def record(self) -> dict:
        return {"collectives": self.collectives, "largest": self.largest}


def ep_world(rank, world, arch, state_dict, batch, cases, eps, seed):
    """``all_to_all_check``, then ``_torch_rank_fns.step_on_mesh`` for
    each case ``(shape, axes, changes)`` (the smoke config with
    ``changes``), its loss and gradients watched (``ExpertWatch``). Rank 0
    returns the steps' gradients, metrics and parameters; every rank the
    all-to-all's check and each step's split, the bytes of its parameter
    shards and what the watch saw."""
    d = state_dict["embed.w"].shape[1]
    steps = []
    for shape, axes, changes in cases:
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes)
        steps.append(fns.step_on_mesh(
            rank, arch, state_dict, batch, mesh, eps, changes=changes,
            watch=lambda m, shape=shape, axes=axes: ExpertWatch(shape, axes,
                                                                d)))
    return {"all_to_all": all_to_all_check(rank, world, seed),
            "steps": steps}


def ep_serve(rank, world, cases):
    """``_torch_serve_fns.serve_cases`` of each case, watched
    (``ExpertWatch``: its collectives)."""
    import _torch_serve_fns as serve_fns

    out = []
    for case in cases:
        cfg, shape, axes = case[0], case[-2], case[-1]
        with ExpertWatch(shape, axes, cfg.d_model) as watch:
            res, = serve_fns.serve_cases(rank, world, [case])
        res["collectives"] = watch.collectives
        out.append(res)
    return out


def all_to_all_check(rank, world, seed):
    """``models.distributed.all_to_all`` over the ``expert`` dim of an
    (4, 2) ``("expert", "data")`` mesh, float32 and bfloat16: the result
    against the blocks every rank sent (each rank's whole input gathered),
    and its backward (the gradient of a random linear function of the
    result) against the reference's gradient. Returns {dtype: (forward
    equal, backward equal)}."""
    from repro_torch.models.distributed import all_to_all

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("expert", "data"))
    group = mesh.get_group("expert")
    ep, me = mesh.size(0), mesh.get_local_rank("expert")
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(seed + dist.get_rank())
        x = torch.from_numpy(rng.standard_normal((ep * 3, 5, 2)).astype(
            np.float32)).to(dtype).requires_grad_(True)
        w = torch.from_numpy(rng.standard_normal((ep * 3, 5, 2)).astype(
            np.float32)).to(dtype)
        y = all_to_all(x, group)
        (y * w).sum().backward()
        # reference: every rank's input and weights, gathered
        xs = [torch.empty_like(x) for _ in range(ep)]
        ws = [torch.empty_like(w) for _ in range(ep)]
        dist.all_gather(xs, x.detach(), group=group)
        dist.all_gather(ws, w, group=group)
        want = torch.cat([xs[i].chunk(ep)[me] for i in range(ep)])
        # d/dx of sum_i <all_to_all(x_i), w_i>: block j of my x lands on
        # rank j at my block, weighed by rank j's w there
        want_grad = torch.cat([ws[j].chunk(ep)[me] for j in range(ep)])
        res[str(dtype)] = (torch.equal(y.detach(), want),
                           torch.equal(x.grad, want_grad))
    return res
