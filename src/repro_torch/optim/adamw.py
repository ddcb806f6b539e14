"""AdamW with decoupled weight decay over dicts of tensors.

The port's training state is the LM's parameters as nested dicts in
``param_tree`` layout (one ``stages.<i>`` subtree per stage). The update runs
in place under ``torch.no_grad()``: parameters and moments are overwritten,
the reference's arithmetic step for step (``src/repro/optim/adamw.py``):
moments in ``moments_dtype`` with float32 math, bias correction from the
incremented step, decay added to ``delta`` before the learning rate.

Decay applies to leaves of rank ``min_decay_ndim`` or more *in the JAX
layout*, where the stages are stacked on a leading axis: a leaf under a
``stages`` key counts one more dimension than it has here (a stage's norm
scale is decayed, the final norm's is not), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, NamedTuple

import torch

__all__ = ["AdamW", "AdamWState", "global_norm", "clip_by_global_norm",
           "tree_items", "tree_leaves", "tree_map", "jax_rank"]


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any


def tree_items(tree, path=()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """(key path, tensor) of every leaf of nested dicts, in sorted-key
    order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], path + (key,))
    else:
        yield path, tree


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def jax_rank(path: tuple, leaf: torch.Tensor) -> int:
    """The leaf's rank in the JAX layout: one more under ``stages``."""
    return leaf.dim() + ("stages" in path)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """``tree`` scaled to a global norm of at most ``max_norm``, and that
    norm (``global_norm(tree)`` unless given)."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moments_dtype: torch.dtype = torch.float32
    # decay applies to matrices only (norms/biases/scalars exempt), by the
    # JAX layout's rank
    min_decay_ndim: int = 2

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moments_dtype,
                               device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr):
        """Updates ``params`` and the moments in place; returns (params,
        new state). ``lr`` is a float or a 0-d tensor."""
        step = state.step + 1
        t = step.float()
        b1t = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32), t)
        b2t = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32), t)
        lr = torch.as_tensor(lr, dtype=torch.float32)
        on = {}  # b1t, b2t, lr on each device the parameters use

        def consts(device):
            if device not in on:
                on[device] = tuple(c.to(device) for c in (b1t, b2t, lr))
            return on[device]

        m_items = dict(tree_items(state.m))
        v_items = dict(tree_items(state.v))
        g_items = dict(tree_items(grads))
        for path, p in tree_items(params):
            g32 = g_items[path].float()
            m, v = m_items[path], v_items[path]
            m32 = self.b1 * m.float() + (1 - self.b1) * g32
            v32 = self.b2 * v.float() + (1 - self.b2) * g32 * g32
            b1t_d, b2t_d, lr_d = consts(p.device)
            mhat = m32 / b1t_d
            vhat = v32 / b2t_d
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            p32 = p.float()
            if jax_rank(path, p) >= self.min_decay_ndim:
                delta = delta + self.weight_decay * p32
            p.copy_(p32 - lr_d * delta)
            m.copy_(m32)
            v.copy_(v32)
        return params, AdamWState(step=step, m=state.m, v=state.v)
