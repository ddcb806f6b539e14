"""int8 gradient compression with error feedback — the distributed-
optimization trick for the DCN (pod-axis) gradient reduce.

Per-tensor symmetric int8 quantisation; the residual (quantisation error)
is carried in an error-feedback buffer and added back before the next
compression, so the scheme is unbiased over time (EF-SGD). Trees are nested
dicts of tensors, as the optimizer's. "Per tensor" means per leaf of the JAX
layout: the leaves of the per-stage subtrees under ``stages`` that the JAX
package stacks into one tensor share one scale, the max over all stages.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .adamw import tree_items, tree_map

__all__ = ["CompressionState", "init_state", "compress", "decompress",
           "compress_tree", "compress_with_feedback"]


class CompressionState(NamedTuple):
    error: Any  # nested dict of float32 residuals, like grads


def init_state(grads) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def compress(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _jax_key(path: tuple) -> tuple:
    """The leaf's path in the JAX layout: without the stage index."""
    if "stages" in path:
        at = path.index("stages")
        return path[:at + 1] + path[at + 2:]
    return path


def compress_tree(tree):
    """:func:`compress` of every leaf, with one scale per JAX-layout leaf
    (stages together). Returns (q_tree, scale_tree)."""
    peak: dict[tuple, torch.Tensor] = {}
    for path, x in tree_items(tree):
        m = x.float().abs().max()
        key = _jax_key(path)
        peak[key] = m if key not in peak else torch.maximum(peak[key], m)
    scales = {key: torch.clamp_min(m, 1e-12) / 127.0
              for key, m in peak.items()}
    q_flat = {}
    for path, x in tree_items(tree):
        scale = scales[_jax_key(path)]
        q_flat[path] = torch.clamp(torch.round(x.float() / scale), -127,
                                   127).to(torch.int8)

    def rebuild(t, path=()):
        if isinstance(t, dict):
            pairs = {k: rebuild(v, path + (k,)) for k, v in t.items()}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        return q_flat[path], scales[_jax_key(path)]
    return rebuild(tree)


def compress_with_feedback(grads, state: CompressionState):
    """Returns ((q_tree, scale_tree), new_state). Decompressing and adding
    the carried error reproduces the input exactly; over steps the feedback
    makes the compression unbiased."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, state.error)
    qs, scales = compress_tree(corrected)
    errs = tree_map(lambda c, q, s: c - decompress(q, s), corrected, qs,
                    scales)
    return (qs, scales), CompressionState(error=errs)
