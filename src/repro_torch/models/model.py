"""LM assembly: a config-driven decoder stack for every family of the JAX
package: attention + MLP/MoE stages (dense, moe, vlm, audio), Mamba stages
(ssm: falcon-mamba) and hybrid periods (jamba: ``attn_every`` sub-layers,
attention at ``attn_offset`` and Mamba elsewhere, MoE on every
``moe_every``-th).

The parameters live in ``nn.Module``s under the JAX package's keys
(``embed``, ``stages.<i>.{norm1, attn, norm2, ffn.{mlp|moe}}`` or
``stages.<i>.{norm, mamba}`` or ``stages.<i>.sub_<j>.{norm1, mixer, norm2,
ffn}``, ``final_norm``, ``unembed``), one module per stage where the JAX
package stacks the stages on a leading axis for ``lax.scan``; the stage
loop is a Python loop. The forward passes read a compute copy of the
weights: matrices in the compute dtype; the router, ``dt_proj`` (both run
in float32), the norms and the SSM's vectors as stored (the JAX package
casts at every call, with the same values). Inference (``apply``,
``prefill``, ``decode_step``) runs without autograd on a detached copy made
once per set of parameter values (any in-place update, an optimizer step's
included, makes a new one). ``loss`` is differentiable: it casts the live
parameters on every call (the embedding table is gathered as stored and
cast after, as the JAX package does), and with ``remat`` recomputes each
stage in the backward pass (``torch.utils.checkpoint``) under the config's
``remat_policy``: ``nothing`` keeps a stage's input alone, ``outputs`` also
its mixer and FFN outputs (each sub-block checkpointed apart).

A sharded LM (``train.sharded.shard_state``) holds DTensor shards, a
``batch`` group and a ``split`` over ``model`` (``models.distributed``):
each sub-block gathers its weights when it runs, inside its checkpoint, so
a remat recompute gathers them again and issues the split's collectives
again; the loss counts the tokens of the whole batch and the MoE aux loss
routes over it. The full-sequence forward (``loss``, ``apply``) computes
each model rank's share: its heads, ff columns, experts, Mamba channels
and vocabulary columns. The loss takes the log-sum-exp and the label's
logit over the split vocabulary (``_split_logz_ll``); ``apply`` gathers
the logits whole. ``prefill`` and ``decode_step`` gather every weight
whole.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels.ref import check_lengths
from .attention import (
    Attention,
    KVCache,
    attn_decode,
    attn_prefill,
    attn_train,
)
from .attention import split_modes as attn_modes
from .distributed import LOCAL, PARTS, WHOLE, columns, gathered
from .common import (
    Dense,
    Embed,
    LayerNorm,
    RMSNorm,
    dense,
    draws,
    dtype_of,
    embed_rows,
    layernorm,
    layernorm_np,
    param_tree,
    rmsnorm,
    sinusoidal_positions,
)
from .mlp import MLP, mlp_apply
from .mlp import split_modes as mlp_modes
from .moe import MoE, moe_apply
from .moe import split_modes as moe_modes
from .ssm import Mamba, SSMCache, ssm_decode, ssm_prefill, ssm_train
from .ssm import split_modes as ssm_modes

__all__ = ["LM"]

_COMPUTE_KEYS = ("w", "b", "wi", "wg", "wo")  # cast to the compute dtype
_FLOAT32_LAYERS = ("router", "dt_proj")        # kept as stored


def _zero_aux(device):
    z = torch.zeros((), device=device)
    return {"moe_aux_loss": z, "overflow": z.long(), "rebalanced": z.long(),
            "dropped": z.long()}


def _compute_copy(tree: dict, dtype: torch.dtype, detach: bool) -> dict:
    """The parameter tree with every matrix and bias in ``dtype``, except
    the router's and ``dt_proj``'s (both run in float32) and the norms';
    cut from autograd with ``detach``."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = (val if key in _FLOAT32_LAYERS
                        else _compute_copy(val, dtype, detach))
        else:
            leaf = val.detach() if detach else val
            out[key] = leaf.to(dtype) if key in _COMPUTE_KEYS else leaf
    return out


def _split_logz_ll(logits, labels, split):
    """(logsumexp over the vocabulary, each label's logit) from this rank's
    vocabulary columns ``logits`` (B, S, V/m): the max over ``model`` (cut
    from autograd: it shifts, it does not change the result), the sum of
    the shifted exponentials summed over ``model``, and the label's logit
    from the rank that holds its column."""
    n = logits.shape[-1]
    top = split.all_max(logits.amax(-1))
    logz = top + torch.log(split.reduce_from(
        torch.exp(logits - top[..., None]).sum(-1)))
    idx = labels - split.block(n)
    mine = (idx >= 0) & (idx < n)
    ll = torch.take_along_dim(logits, idx.clamp(0, n - 1)[..., None],
                              dim=-1)[..., 0]
    return logz, split.reduce_from(torch.where(
        mine, ll, torch.zeros((), dtype=ll.dtype, device=ll.device)))


def _split_modes(split, kind: str) -> dict:
    """How the split uses each weight of the LM (``models.distributed``),
    as each layer declares it, with a mixer of ``kind``: the embedding
    keeps its vocabulary rows, the untied unembedding (cut by the plans
    along d) is gathered whole and a rank uses its vocabulary block's
    columns (parts)."""
    mixer = attn_modes if kind == "attn" else ssm_modes
    return {"embed": LOCAL if split.vocab else WHOLE,
            "unembed": PARTS if split.vocab else WHOLE,
            "mixer": mixer(split),
            "ffn": {"mlp": mlp_modes(split), "moe": moe_modes(split)}}


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


class _Norm(nn.Module):
    """A norm's parameters, none for OLMo's non-parametric LayerNorm."""


class _FFN(nn.Module):
    def __init__(self, child_name: str, child: nn.Module):
        super().__init__()
        self.add_module(child_name, child)


def _ffn(cfg: ModelConfig, layer_idx: int, dtype, device) -> _FFN:
    """The JAX package's ``_ffn_init(key, layer_idx)``: MoE iff the config
    has experts and ``layer_idx % moe_every == moe_every - 1``."""
    if cfg.is_moe and layer_idx % cfg.moe_every == cfg.moe_every - 1:
        return _FFN("moe", MoE(cfg, dtype=dtype, device=device))
    return _FFN("mlp", MLP(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                           n_layers=cfg.n_layers, dtype=dtype,
                           device=device))


class Stage(nn.Module):
    """An attention family's layer: ``{"norm1", "attn", "norm2", "ffn":
    {"mlp"|"moe"}}`` (the JAX package's ``_ffn_init(key, 0)``: MoE in every
    stage iff ``moe_every == 1``)."""

    def __init__(self, cfg: ModelConfig, norm, dtype, device):
        super().__init__()
        self.norm1 = norm()
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.norm2 = norm()
        self.ffn = _ffn(cfg, 0, dtype, device)


class SSMStage(nn.Module):
    """A Mamba layer (ssm family): ``{"norm", "mamba"}``, no FFN."""

    def __init__(self, cfg: ModelConfig, norm, dtype, device):
        super().__init__()
        self.norm = norm()
        self.mamba = Mamba(cfg, dtype=dtype, device=device)


class _SubLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, j: int, norm, dtype, device):
        super().__init__()
        self.norm1 = norm()
        self.mixer = (Attention(cfg, dtype=dtype, device=device)
                      if j == cfg.attn_offset
                      else Mamba(cfg, dtype=dtype, device=device))
        self.norm2 = norm()
        self.ffn = _ffn(cfg, j, dtype, device)


class HybridStage(nn.Module):
    """One hybrid period: ``{"sub_<j>": {"norm1", "mixer", "norm2",
    "ffn"}}`` for j < ``attn_every``; the mixer is attention at
    ``attn_offset`` and Mamba elsewhere."""

    def __init__(self, cfg: ModelConfig, norm, dtype, device):
        super().__init__()
        for j in range(cfg.attn_every):
            self.add_module(f"sub_{j}", _SubLayer(cfg, j, norm, dtype,
                                                  device))


_STAGES = {"ssm": SSMStage, "hybrid": HybridStage}


def _at(cache, i: int):
    """Stage ``i`` of a cache tree (views, so writes land in the cache)."""
    if isinstance(cache, dict):
        return {key: _at(val, i) for key, val in cache.items()}
    return type(cache)(*(t[i] for t in cache))


class LM(nn.Module):
    """The decoder LM on ``device`` (None: the CUDA device, or raise).
    With ``materialize=False`` the parameters are built on meta and take no
    memory until ``init`` (or ``train.sharded.shard_state``, which keeps a
    rank's shards alone) draws them on ``device``, one leaf at a time.

    ``init(generator)`` draws the parameters; ``load_state_dict`` takes
    converted JAX parameters (``models.convert.from_jax_params``). Then
    ``prefill``/``decode_step`` serve and ``apply`` runs the full-sequence
    forward. Caches carry a leading ``n_stages`` axis and are written in
    place: ``KVCache`` (n_stages, B, L, KV, hd) for the attention families,
    ``SSMCache`` (n_stages, B, di, N) / (n_stages, B, K-1, di) for ssm, and
    for hybrid a dict ``{"sub_<j>": KVCache | SSMCache}``, as the JAX
    package's cache pytree.
    """

    def __init__(self, cfg: ModelConfig, device=None, *,
                 materialize: bool = True):
        super().__init__()
        if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
            raise ValueError("hybrid needs n_layers % attn_every == 0")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_stages = (cfg.n_layers // cfg.attn_every
                         if cfg.family == "hybrid" else cfg.n_layers)
        self.compute_dtype = dtype_of(cfg.dtype)
        self.param_dtype = dtype_of(cfg.param_dtype)
        dt = self.param_dtype
        dev = self.device if materialize else torch.device("meta")
        if cfg.norm_type == "rmsnorm":
            def norm():
                return RMSNorm(cfg.d_model, dt, dev)
        elif cfg.norm_type == "layernorm":
            def norm():
                return LayerNorm(cfg.d_model, dt, dev)
        else:
            norm = _Norm
        self.embed = Embed(cfg.vocab_padded, cfg.d_model, dt, dev)
        if cfg.prefix_len:
            self.prefix_proj = Dense(cfg.prefix_dim, cfg.d_model, dtype=dt,
                                     device=dev)
        stage = _STAGES.get(cfg.family, Stage)
        self.stages = nn.ModuleList(stage(cfg, norm, dt, dev)
                                    for _ in range(self.n_stages))
        self.final_norm = norm()
        if not cfg.tie_embeddings:
            self.unembed = Dense(cfg.d_model, cfg.vocab_padded, dtype=dt,
                                 device=dev)
        self._weights = None
        self._weights_key = None
        self.batch = None       # a sharded LM's BatchGroup
        self.split = None       # and its ModelSplit

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Draw every parameter from ``generator`` on the LM's device, one
        leaf at a time (``models.common.draws``); a parameter still on meta
        (``materialize=False``) is made there."""
        for name, value in draws(self, generator, self.device):
            p = self.get_parameter(name)
            if p.is_meta:
                owner, _, leaf = name.rpartition(".")
                setattr(self.get_submodule(owner), leaf, nn.Parameter(
                    value.to(p.dtype).contiguous(),
                    requires_grad=p.requires_grad))
            else:
                p.copy_(value)
        self._weights = None
        return self

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        self._weights = None
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def _apply(self, fn, *args, **kwargs):
        self._weights = None
        return super()._apply(fn, *args, **kwargs)

    def _copy(self, detach: bool) -> dict:
        tree = _compute_copy(param_tree(self), self.compute_dtype, detach)
        tree["stages"] = [tree["stages"][str(i)]
                          for i in range(self.n_stages)]
        return tree

    def weights(self) -> dict:
        """The detached compute copy of the parameters, as the JAX package's
        nested dict (``stages`` a list of per-stage dicts); remade when a
        parameter has changed in place since (its version counter)."""
        key = tuple(p._version for p in self.parameters())
        if self._weights is None or key != self._weights_key:
            self._weights = self._copy(detach=True)
            self._weights_key = key
        return self._weights

    def live_weights(self) -> dict:
        """The compute copy cast from the live parameters, in autograd's
        graph (made anew at each call); the embedding table as stored."""
        tree = self._copy(detach=False)
        tree["embed"] = {"w": self.embed.w}
        return tree

    def _full(self, tree, split=None, kind="attn"):
        """A (sub)tree of weights gathered from their shards on a sharded
        LM (whole, or as ``split`` computes on them: its modes for a
        ``kind`` of mixer), as they are otherwise."""
        if self.batch is None:
            return tree
        return gathered(tree, self.batch, WHOLE if split is None
                        else _split_modes(split, kind))

    def _top(self, w: dict, split=None) -> dict:
        """``w`` with every weight outside the stages gathered."""
        return {**self._full({k: v for k, v in w.items() if k != "stages"},
                             split),
                "stages": w["stages"]}

    def stage_meta(self) -> list[bool]:
        """is_global per stage (gemma3: one global layer per
        ``global_every``)."""
        cfg = self.cfg
        if cfg.global_every:
            return [i % cfg.global_every == cfg.global_every - 1
                    for i in range(self.n_stages)]
        return [not cfg.sliding_window] * self.n_stages

    # ------------------------------------------------------------------
    # layers
    # ------------------------------------------------------------------
    def _norm(self, p, x):
        if self.cfg.norm_type == "rmsnorm":
            return rmsnorm(p, x)
        if self.cfg.norm_type == "layernorm":
            return layernorm(p, x)
        return layernorm_np(x)

    def _ffn_apply(self, p, x, split=None):
        if "moe" in p:
            return moe_apply(p["moe"], x, self.cfg, mode=self.cfg.moe_mode,
                             batch=self.batch, split=split)
        return (mlp_apply(p["mlp"], x, activation=self.cfg.activation,
                          split=split),
                _zero_aux(x.device))

    def _embed(self, w, tokens, positions=None, split=None):
        cfg = self.cfg
        x = embed_rows(w["embed"]["w"], tokens, split).to(
            self.compute_dtype)
        if cfg.embed_scale != 1.0:
            x = x * torch.tensor(cfg.embed_scale, dtype=self.compute_dtype)
        if cfg.pos_embed == "sinusoidal":
            if positions is None:
                positions = torch.arange(tokens.shape[1], device=x.device)
            x = x + sinusoidal_positions(positions, cfg.d_model).to(
                self.compute_dtype)
        return x

    def _logits(self, w, x, split=None):
        """float32 logits: this rank's vocabulary columns with
        ``split.vocab`` (the tied table's rows it holds, or its block of
        the whole unembedding's columns)."""
        if split is not None and split.vocab:
            x = split.copy_to(x)
            if not self.cfg.tie_embeddings:
                spans = split.spans(self.cfg.vocab_padded)
                return dense({k: columns(v, spans)
                              for k, v in w["unembed"].items()}, x,
                             self.compute_dtype).float()
        if self.cfg.tie_embeddings:
            logits = x @ w["embed"]["w"].to(self.compute_dtype).T
        else:
            logits = dense(w["unembed"], x, self.compute_dtype)
        return logits.float()

    def _as_long(self, t):
        return torch.as_tensor(t, device=self.device).long()

    def _sublayers(self, sp):
        """A stage's sub-layers as ``(mixer kind, cache key, {"norm1",
        "mixer", "norm2"?, "ffn"?})``: one for the attention families and
        ssm (no FFN), ``attn_every`` for hybrid (cache key ``sub_<j>``)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return [("ssm", None, {"norm1": sp["norm"],
                                   "mixer": sp["mamba"]})]
        if cfg.family == "hybrid":
            return [("attn" if j == cfg.attn_offset else "ssm", f"sub_{j}",
                     sp[f"sub_{j}"]) for j in range(cfg.attn_every)]
        return [("attn", None, {"norm1": sp["norm1"], "mixer": sp["attn"],
                                "norm2": sp["norm2"], "ffn": sp["ffn"]})]

    def _stage(self, sp, x, mix, is_global, cache=None, remat_parts=False,
               split=None):
        """One stage: per sub-layer ``x + mixer(norm1(x))``, then ``x +
        ffn(norm2(x))`` where it has an FFN. ``mix(kind, p, h, cache,
        is_global)`` runs the mixer. With ``remat_parts`` each mixer and FFN
        block (norm included) is checkpointed apart, so the backward keeps
        their outputs and recomputes their insides. Each block gathers its
        weights as it runs (``_full``; as ``split`` computes on them).
        Returns (x, aux)."""
        aux = _zero_aux(x.device)
        for kind, key, sub in self._sublayers(sp):
            c = cache if key is None or cache is None else cache[key]

            def mixer(h, kind=kind, sub=sub, c=c):
                p = self._full({"norm1": sub["norm1"], "mixer": sub["mixer"]},
                               split, kind)
                return mix(kind, p["mixer"], self._norm(p["norm1"], h), c,
                           is_global)

            x = x + (_checkpointed(mixer, x) if remat_parts else mixer(x))
            if "ffn" in sub:
                def ffn(h, sub=sub):
                    p = self._full({"norm2": sub["norm2"], "ffn": sub["ffn"]},
                                   split)
                    return self._ffn_apply(p["ffn"],
                                           self._norm(p["norm2"], h), split)

                h, a = _checkpointed(ffn, x) if remat_parts else ffn(x)
                x = x + h
                aux = {k: aux[k] + a[k] for k in aux}
        return x, aux

    # ------------------------------------------------------------------
    # forward passes
    # ------------------------------------------------------------------
    @torch.no_grad()
    def apply(self, tokens, *, prefix_embed=None):
        """tokens: (B, S) -> (logits (B, S', V) float32, aux). With a
        modality prefix the sequence is [prefix; tokens] and logits cover
        token positions."""
        logits, aux = self._forward(self.weights(), tokens,
                                    prefix_embed=prefix_embed)
        if self.split is not None and self.split.vocab:
            logits = self.split.gather_from(logits, -1)
        return logits, aux

    def loss(self, batch, *, remat=False):
        """batch: {"tokens": (B, S), "labels": (B, S) with -1 = masked,
        optional "prefix_embed"}, tensors or arrays. Returns (scalar loss,
        metrics): the mean cross-entropy over unmasked labels (logits in
        float32) plus 1e-2 x the MoE aux loss / n_layers, differentiable in
        the parameters; metrics ``ce``, ``tokens`` and the aux counters.
        On a sharded LM ``batch`` holds this rank's rows: the mean is over
        the whole batch's unmasked labels, so the loss, ``ce`` and the aux
        terms are this rank's shares (they sum to the whole batch's over
        the batch's ranks) and ``tokens`` is the whole batch's count."""
        logits, aux = self._forward(self.live_weights(), batch["tokens"],
                                    prefix_embed=batch.get("prefix_embed"),
                                    remat=remat)
        labels = self._as_long(batch["labels"])
        mask = labels >= 0
        safe = torch.where(mask, labels, 0)
        if self.split is not None and self.split.vocab:
            logz, ll = _split_logz_ll(logits, safe, self.split)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.take_along_dim(logits, safe[..., None],
                                      dim=-1)[..., 0]
        nll = (logz - ll) * mask
        n_tok = mask.sum()
        if self.batch is not None:
            self.batch.sum_(n_tok)
        n_tok = torch.clamp_min(n_tok, 1)
        ce = nll.sum() / n_tok
        total = ce + 1e-2 * aux["moe_aux_loss"] / max(self.cfg.n_layers, 1)
        return total, {"ce": ce, "tokens": n_tok, **aux}

    def _forward(self, w, tokens, *, prefix_embed=None, remat=False):
        """The full-sequence forward over the weight copy ``w``, split over
        ``model`` on a sharded LM (the logits: this rank's vocabulary
        columns where the vocabulary splits); ``remat`` checkpoints each
        stage under ``cfg.remat_policy``."""
        cfg = self.cfg
        split = self.split
        w = self._top(w, split)
        tokens = self._as_long(tokens)
        x = self._embed(w, tokens, split=split)
        n_prefix = 0
        if prefix_embed is not None:
            pe = torch.as_tensor(prefix_embed, device=self.device)
            pe = dense(w["prefix_proj"], pe.to(self.compute_dtype),
                       self.compute_dtype)
            x = torch.cat([pe, x], dim=1)
            n_prefix = pe.shape[1]
        b, s, _ = x.shape
        positions = torch.arange(s, device=self.device).expand(b, s)

        def mix(kind, p, h, _cache, is_global):
            if kind == "attn":
                return attn_train(p, h, cfg, positions=positions,
                                  is_global=is_global, split=split)
            return ssm_train(p, h, cfg, split=split)

        if remat and cfg.remat_policy not in ("nothing", "outputs"):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        whole = remat and cfg.remat_policy == "nothing"
        aux = _zero_aux(self.device)
        for sp, is_global in zip(w["stages"], self.stage_meta()):
            if whole:
                x, a = _checkpointed(self._stage, sp, x, mix, is_global,
                                     None, False, split)
            else:
                x, a = self._stage(sp, x, mix, is_global,
                                   remat_parts=remat, split=split)
            aux = {key: aux[key] + a[key] for key in aux}
        x = self._norm(w["final_norm"], x)
        if n_prefix:
            x = x[:, n_prefix:]
        return self._logits(w, x, split), aux

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """Zero caches with a leading ``n_stages`` axis on the LM's device:
        KV caches (.., batch, max_len, KV, hd) in ``kv_cache_dtype``, SSM
        state (.., batch, di, N) and conv window (.., batch, K-1, di) in the
        compute dtype (``dtype`` overrides both), in the family's layout
        (see the class docstring)."""
        cfg = self.cfg
        kv_dtype = dtype_of(cfg.kv_cache_dtype) if dtype is None else dtype
        ssm_dtype = self.compute_dtype if dtype is None else dtype
        lead, dev = (self.n_stages, batch), self.device

        def kv():
            shape = lead + (max_len, cfg.n_kv_heads, cfg.head_dim_)
            return KVCache(torch.zeros(shape, dtype=kv_dtype, device=dev),
                           torch.zeros(shape, dtype=kv_dtype, device=dev))

        def ssm():
            return SSMCache(
                torch.zeros(lead + (cfg.d_inner, cfg.ssm_state),
                            dtype=ssm_dtype, device=dev),
                torch.zeros(lead + (cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=ssm_dtype, device=dev))

        if cfg.family == "ssm":
            return ssm()
        if cfg.family == "hybrid":
            return {f"sub_{j}": kv() if j == cfg.attn_offset else ssm()
                    for j in range(cfg.attn_every)}
        return kv()

    @torch.no_grad()
    def prefill(self, cache, tokens, lengths):
        """Process right-padded prompts and populate the cache.

        tokens: (B, S); lengths: (B,) real lengths, each in [1, S] (S <=
        cache max_len; checked when they are given on the host).
        Returns (last-token logits (B, V) float32, cache)."""
        cfg = self.cfg
        w = self._top(self.weights())
        tokens = self._as_long(tokens)
        b, s = tokens.shape
        lengths = torch.as_tensor(lengths)
        check_lengths(lengths, b, s, values=lengths.device.type == "cpu")
        lengths = lengths.to(device=self.device, dtype=torch.int32)
        pos = torch.arange(s, device=self.device).expand(b, s)
        mask = pos < lengths[:, None]

        def mix(kind, p, h, c, is_global):
            if kind == "attn":
                return attn_prefill(p, h, cfg, c, lengths=lengths,
                                    is_global=is_global)[0]
            return ssm_prefill(p, h, cfg, c, mask=mask)[0]

        x = self._embed(w, tokens)
        for i, (sp, is_global) in enumerate(zip(w["stages"],
                                                self.stage_meta())):
            x, _ = self._stage(sp, x, mix, is_global, _at(cache, i))
        x = self._norm(w["final_norm"], x)
        last = x[torch.arange(b, device=self.device),
                 (lengths - 1).clamp_min(0).long()]        # (B, d)
        return self._logits(w, last), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, lengths):
        """tokens: (B, 1) current token; lengths: (B,) its position.
        Returns (logits (B, 1, V) float32, cache)."""
        cfg = self.cfg
        w = self._top(self.weights())
        tokens = self._as_long(tokens)
        lengths = self._as_long(lengths)

        def mix(kind, p, h, c, is_global):
            if kind == "attn":
                return attn_decode(p, h, cfg, c, lengths,
                                   is_global=is_global)[0]
            return ssm_decode(p, h, cfg, c)[0]

        x = self._embed(w, tokens, positions=lengths[:, None])
        for i, (sp, is_global) in enumerate(zip(w["stages"],
                                                self.stage_meta())):
            x, _ = self._stage(sp, x, mix, is_global, _at(cache, i))
        x = self._norm(w["final_norm"], x)
        return self._logits(w, x), cache
