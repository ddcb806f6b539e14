"""Sharding plans: logical-axis rules + parameter/optimizer/batch/cache
specs for every (config x mesh x shape) cell, and their DTensor placements.

The JAX package's plans (``src/repro/launch/shardings.py``) rule for rule.
A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of axis names (``("pod", "data")``: sharded
over both, pod-major). ``placements(mesh, spec)`` turns one into the
``DTensor`` placements of a ``DeviceMesh``: ``Shard(d)`` on every mesh dim
that shards tensor dim d, ``Replicate()`` on the others.

Layout:
  * params: 2-D sharded — FSDP dim over ``data``, TP dim over ``model``;
    replicated across ``pod`` (pod = DP),
  * optimizer moments: FSDP dim over ``(pod, data)`` (ZeRO-1 across pods),
  * activations: logical names resolved per-config (heads shard over
    ``model`` only when the head count divides it),
  * decode KV caches: sequence dim over ``model``; ``long_500k`` (batch=1)
    additionally spreads the sequence over ``(data, model)``.

The port's parameters are per stage (``stages.<i>.…``) where the JAX
package stacks them on a leading stage axis; each one is matched under its
JAX path (``models.convert.jax_key``), and a stacked leaf's spec drops the
leading stage entry. The caches keep the JAX layout (leading ``n_stages``)
and their specs carry over unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ModelConfig, ShapeSpec
from ..models.attention import KVCache
from ..models.convert import jax_key
from ..models.distributed import ModelSplit
from ..models.ssm import SSMCache
from .mesh import mesh_axis_sizes

__all__ = ["moe_layout", "activation_rules", "compute_split",
           "param_pspecs", "moment_pspecs", "state_pspecs", "batch_pspecs",
           "cache_pspecs", "serve_shape", "cache_split", "placements"]


def _fit(dim: int, size: int, axis):
    """Use ``axis`` only if it divides the dimension."""
    return axis if dim % size == 0 else None


def moe_layout(cfg: ModelConfig, ax: dict) -> dict:
    """Where the MoE data path lives (shared by param specs and activation
    rules).

      e_ax       — axis carrying the expert dim: dedicated ``expert`` axis
                   if present & divisible, else ``model`` if divisible,
                   else None (legacy 2-D weight sharding),
      act_ff     — axis sharding the *activation* hidden dim h (disjoint
                   from e_ax and the group axes),
      weight_ff  — axes sharding the *weight* ff dim (act_ff + data-FSDP;
                   the data part is gathered per layer at use),
      group_axes — axes sharding the token-group dim of (G, E, C, d).
    """
    if not cfg.n_experts:
        return {"e_ax": None, "act_ff": None, "weight_ff": None,
                "group_axes": None, "legacy": False}
    if cfg.moe_layout_mode == "legacy":
        return {"e_ax": None, "act_ff": None, "weight_ff": None,
                "group_axes": None, "legacy": True}
    if "expert" in ax and cfg.n_experts % ax["expert"] == 0:
        e_ax = "expert"
        group_axes = tuple(a for a in ("data",) if a in ax) or None
        act_ff = _fit(cfg.d_ff, ax["model"], "model")
        wf = [a for a in ("data", "model") if a in ax]
        weight_ff = tuple(wf) if cfg.d_ff % int(
            np.prod([ax[a] for a in wf])) == 0 else act_ff
    elif cfg.n_experts % ax["model"] == 0:
        e_ax = "model"
        group_axes = tuple(a for a in ("pod", "data") if a in ax)
        act_ff = None                    # data carries groups, model experts
        weight_ff = _fit(cfg.d_ff, ax["data"], "data")
    else:
        return {"e_ax": None, "act_ff": None, "weight_ff": None,
                "group_axes": None, "legacy": True}
    return {"e_ax": e_ax, "act_ff": act_ff, "weight_ff": weight_ff,
            "group_axes": group_axes, "legacy": False}


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation_rules(cfg: ModelConfig, mesh, shape: ShapeSpec | None = None
                     ) -> dict[str, Any]:
    ax = mesh_axis_sizes(mesh)
    model = ax["model"]
    batch_axes = tuple(a for a in ("pod", "expert", "data") if a in ax)
    batch_size = int(np.prod([ax[a] for a in batch_axes]))
    rules: dict[str, Any] = {
        "batch": batch_axes if (shape is None
                                or shape.global_batch % batch_size == 0)
        else None,
        "ff": "model",
        "vocab": "model",
        "heads": _fit(cfg.n_heads or 1, model, "model"),
        "kv_heads": _fit(cfg.n_kv_heads or 1, model, "model"),
        "heads_flat": _fit((cfg.n_heads or 1) * cfg.head_dim_ or 1, model,
                           "model"),
    }
    # expert parallelism for the MoE data path
    layout = moe_layout(cfg, ax)
    rules["experts"] = layout["e_ax"]
    rules["moe_group"] = layout["group_axes"]
    rules["moe_ff"] = layout["act_ff"]
    if layout["legacy"]:
        # legacy path: groups over the batch axes, h over model (matches
        # the (None, data, model) weight sharding)
        rules["moe_group"] = rules["batch"]
        rules["moe_ff"] = "model"
    return rules


def compute_split(cfg: ModelConfig, mesh, rules: dict | None = None
                  ) -> dict[str, bool]:
    """Which dims the train step and serving compute split over ``model``,
    read from the activation rules (``rules``, default this config's on
    ``mesh``; a serve cell's ``activation_rules(cfg, mesh, shape)`` differ
    only in ``batch``) and fitted as the parameter plans cut the weights:
    ``heads`` and ``kv_heads`` (query and KV heads), ``ff`` (the MLPs'
    hidden dim), ``vocab`` (the padded vocabulary), ``experts``
    (``moe_layout``'s ``e_ax == "model"``), ``moe_ff`` (the experts'
    hidden dim: the legacy layout, or ``act_ff == "model"``) and ``inner``
    (Mamba's channels, which the JAX package constrains by the ``ff``
    rule); and ``ep``, the experts split over the ``expert`` axis
    (``e_ax == "expert"``). The ``model`` flags are all False on a model
    axis of size 1 (or none), ``ep`` on an expert axis of size 1 (or
    none): the step computes as without a mesh."""
    ax = mesh_axis_sizes(mesh)
    m = ax.get("model", 1)
    split = dict.fromkeys(ModelSplit.KEYS, False)
    if m == 1 and ax.get("expert", 1) == 1:
        return split
    rules = activation_rules(cfg, mesh) if rules is None else rules
    split["ep"] = (cfg.n_experts > 0 and ax.get("expert", 1) > 1
                   and rules.get("experts") == "expert")
    if m == 1:
        return split

    def on(logical: str, dim: int) -> bool:
        return rules.get(logical) == "model" and dim % m == 0

    heads = on("heads", cfg.n_heads or 1) and cfg.n_heads > 0
    split.update(
        heads=heads,
        kv_heads=heads and on("kv_heads", cfg.n_kv_heads or 1),
        ff=cfg.family != "ssm" and on("ff", cfg.d_ff or 1),
        vocab=on("vocab", cfg.vocab_padded),
        experts=cfg.n_experts > 0 and rules.get("experts") == "model",
        moe_ff=(cfg.n_experts > 0 and rules.get("experts") != "model"
                and on("moe_ff", cfg.d_ff)),
        inner=cfg.is_ssm and on("ff", cfg.d_inner))
    return split


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _base_spec(path: str, shape: tuple[int, ...], ax: dict,
               cfg: ModelConfig | None = None) -> tuple:
    """Spec for one parameter leaf under its JAX path, before the stacked
    stage dim."""
    d_ax, m_ax = ax["data"], ax["model"]

    def fd(i):  # fit data
        return _fit(shape[i], d_ax, "data")

    def fm(i):  # fit model
        return _fit(shape[i], m_ax, "model")

    def expert_spec(up_proj: bool) -> tuple:
        """Expert weights — wi/wg: (E, d, ff); wo: (E, ff, d)."""
        layout = moe_layout(cfg, ax)
        if layout["legacy"] or layout["e_ax"] is None:
            return ((None, fd(1), fm(2)) if up_proj
                    else (None, fm(1), fd(2)))
        e_ax, wff = layout["e_ax"], layout["weight_ff"]
        return (e_ax, None, wff) if up_proj else (e_ax, wff, None)

    if path.endswith("embed/w"):                    # (V, d)
        return (fm(0), None)
    if path.endswith("unembed/w"):                  # (d, V)
        return (None, fm(1))
    if path.endswith("prefix_proj/w"):              # (pd, d)
        return (fd(0), None)
    if "router/w" in path:                          # (d, E)
        return (fd(0), None)
    if "/moe/" in path and path.endswith(("wi", "wg")):   # (E, d, ff)
        return expert_spec(up_proj=True)
    if "/moe/" in path and path.endswith("wo"):           # (E, ff, d)
        return expert_spec(up_proj=False)
    if path.endswith(("wq/w", "wk/w", "wv/w", "wi/w", "wg/w", "in_proj/w")):
        return (fd(0), fm(1))                       # (d, X): FSDP x TP
    if path.endswith(("wq/b", "wk/b", "wv/b", "wi/b", "wg/b")):
        return (fm(0),)
    if path.endswith(("wo/w", "out_proj/w")):       # (X, d)
        return (fm(0), fd(1))
    if path.endswith("x_proj/w"):                   # (di, dr+2N)
        return (fm(0), None)
    if path.endswith("dt_proj/w"):                  # (dr, di)
        return (None, fm(1))
    if path.endswith("conv_w"):                     # (K, di)
        return (None, fm(1))
    if path.endswith(("conv_b", "dt_bias", "D")):   # (di,)
        return (fm(0),)
    if path.endswith("A_log"):                      # (di, N)
        return (fm(0), None)
    # norms / scalars / anything small: replicated
    return (None,) * len(shape)


def _tree_map_named(fn, tree, prefix=""):
    """``fn(dotted name, leaf)`` over nested dicts (``param_tree`` layout:
    a stage's subtree under ``stages`` -> ``"<i>"``)."""
    if isinstance(tree, dict):
        return {k: _tree_map_named(fn, v, f"{prefix}{k}.")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_pspecs(params, cfg: ModelConfig, mesh):
    """Specs matching a parameter tree in ``param_tree`` layout (leaves:
    anything with a ``shape``: tensors, meta tensors, DTensors)."""
    ax = mesh_axis_sizes(mesh)

    def one(name, leaf):
        path, _ = jax_key(name)
        return _base_spec(path, tuple(leaf.shape), ax, cfg)

    return _tree_map_named(one, params)


def moment_pspecs(params, cfg: ModelConfig, mesh):
    """Like param specs, with the FSDP dim widened to (pod, data) when a pod
    axis exists (ZeRO-1 across pods). Falls back to the param spec when the
    dim doesn't divide the widened axis."""
    ax = mesh_axis_sizes(mesh)
    base = param_pspecs(params, cfg, mesh)
    if "pod" not in ax:
        return base
    wide = ax["pod"] * ax["data"]

    def widen(name, leaf):
        node = base
        for part in name.split("."):
            node = node[part]
        return tuple(("pod", "data") if part == "data"
                     and leaf.shape[i] % wide == 0 else part
                     for i, part in enumerate(node))

    return _tree_map_named(widen, params)


def state_pspecs(state, cfg: ModelConfig, mesh):
    """Specs for a TrainState(params, opt=(step, m, v))."""
    from ..optim.adamw import AdamWState
    from ..train.state import TrainState
    return TrainState(params=param_pspecs(state.params, cfg, mesh),
                      opt=AdamWState(step=(),
                                     m=moment_pspecs(state.opt.m, cfg, mesh),
                                     v=moment_pspecs(state.opt.v, cfg,
                                                     mesh)))


# ---------------------------------------------------------------------------
# batch & cache
# ---------------------------------------------------------------------------

def _entry(axes):
    """One spec entry of ``axes``: a single axis by its name, as JAX's
    ``PartitionSpec`` writes it."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def batch_pspecs(cfg: ModelConfig, mesh, shape: ShapeSpec):
    rules = activation_rules(cfg, mesh, shape)
    b = _entry(rules["batch"])
    specs = {"tokens": (b, None), "labels": (b, None)}
    if cfg.prefix_len:
        specs["prefix_embed"] = (b, None, None)
    return specs


def cache_pspecs(cache, cfg: ModelConfig, mesh, shape: ShapeSpec):
    """Specs for the stacked decode cache (leading dim = stages)."""
    ax = mesh_axis_sizes(mesh)
    rules = activation_rules(cfg, mesh, shape)
    b = _entry(rules["batch"])
    model = ax["model"]
    # sequence dim of the KV cache: model axis; batch=1 long-context also
    # takes the data axis (cache is the dominant tensor there)
    if b is None and "data" in ax:
        seq_axes = ("data", "model")
        seq_div = ax["data"] * model
    else:
        seq_axes = "model"
        seq_div = model

    def walk(node):
        if isinstance(node, KVCache):
            # (L, B, maxlen, KV, hd)
            ml = node.k.shape[2]
            seq = seq_axes if ml % seq_div == 0 else None
            spec = (None, b, seq, None, None)
            return KVCache(k=spec, v=spec)
        if isinstance(node, SSMCache):
            di = node.state.shape[2]
            return SSMCache(
                state=(None, b, _fit(di, model, "model"), None),
                conv=(None, b, None, _fit(node.conv.shape[-1], model,
                                          "model")))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        raise TypeError(f"unexpected cache node {type(node)}")

    return walk(cache)


def serve_shape(batch: int, max_len: int) -> ShapeSpec:
    """The serving cell of a cache of ``batch`` rows (the whole batch) and
    ``max_len`` positions, as ``activation_rules`` and ``cache_pspecs``
    read a shape."""
    return ShapeSpec("serve", max_len, batch, "decode")


def cache_split(cfg: ModelConfig, mesh, shape: ShapeSpec) -> tuple:
    """The mesh dims that cut the KV cache's sequence in ``shape``'s cell
    (``global_batch`` rows, ``seq_len`` positions), in mesh order: the
    sequence entry of ``cache_pspecs`` (``model``, or ``("data",
    "model")`` where the batch does not split), ``()`` where the length
    does not divide."""
    meta = torch.empty((1, shape.global_batch, shape.seq_len,
                        max(cfg.n_kv_heads, 1), max(cfg.head_dim_, 1)),
                       device="meta")
    seq = cache_pspecs(KVCache(meta, meta), cfg, mesh, shape).k[2]
    return (seq,) if isinstance(seq, str) else tuple(seq or ())


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: tuple) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh dim that shards tensor dim d (several mesh dims on one tensor
    dim split it in mesh order, pod-major as in JAX), ``Replicate()``
    elsewhere."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in dims:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"shards two tensor dims")
            out[i] = Shard(d)
    return tuple(out)
