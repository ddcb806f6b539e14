"""LM assembly: a config-driven decoder stack for the families whose stage is
attention + MLP/MoE (dense, moe, vlm, audio).

The parameters live in ``nn.Module``s under the JAX package's keys
(``embed``, ``stages.<i>.{norm1, attn, norm2, ffn.{mlp|moe}}``,
``final_norm``, ``unembed``), one module per stage where the JAX package
stacks the stages on a leading axis for ``lax.scan``; the stage loop is a
Python loop. The forward passes read a compute copy of the weights, made
once per set of parameters: matrices in the compute dtype, the router and
the norms as stored (the JAX package casts at every call, with the same
values). Inference runs without autograd; ``loss``, ``remat`` and the
training path come with the training slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (
    Attention,
    KVCache,
    attn_decode,
    attn_prefill,
    attn_train,
)
from .common import (
    Dense,
    Embed,
    LayerNorm,
    RMSNorm,
    dense,
    dtype_of,
    layernorm,
    layernorm_np,
    param_tree,
    rmsnorm,
    sinusoidal_positions,
)
from .mlp import MLP, mlp_apply
from .moe import MoE, moe_apply

__all__ = ["LM"]

_ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")
_COMPUTE_KEYS = ("w", "b", "wi", "wg", "wo")  # cast to the compute dtype


def _zero_aux(device):
    z = torch.zeros((), device=device)
    return {"moe_aux_loss": z, "overflow": z.long(), "rebalanced": z.long(),
            "dropped": z.long()}


def _compute_copy(tree: dict, dtype: torch.dtype) -> dict:
    """The parameter tree with every matrix and bias in ``dtype``, except
    the router's (the router runs in float32) and the norms'."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = val if key == "router" else _compute_copy(val, dtype)
        elif key in _COMPUTE_KEYS:
            out[key] = val.detach().to(dtype)
        else:
            out[key] = val.detach()
    return out


class _Norm(nn.Module):
    """A norm's parameters, none for OLMo's non-parametric LayerNorm."""


class _FFN(nn.Module):
    def __init__(self, child_name: str, child: nn.Module):
        super().__init__()
        self.add_module(child_name, child)


class Stage(nn.Module):
    """``{"norm1", "attn", "norm2", "ffn": {"mlp"|"moe"}}``."""

    def __init__(self, cfg: ModelConfig, norm, dtype, device):
        super().__init__()
        self.norm1 = norm()
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.norm2 = norm()
        # the JAX package's _ffn_init(key, 0): MoE in every stage iff
        # moe_every == 1 (other periods interleave only in the hybrid stage)
        if cfg.is_moe and cfg.moe_every == 1:
            self.ffn = _FFN("moe", MoE(cfg, dtype=dtype, device=device))
        else:
            self.ffn = _FFN("mlp", MLP(cfg.d_model, cfg.d_ff,
                                       gated=cfg.mlp_gated,
                                       n_layers=cfg.n_layers, dtype=dtype,
                                       device=device))


class LM(nn.Module):
    """The decoder LM on ``device`` (None: the CUDA device, or raise).

    ``init(generator)`` draws the parameters; ``load_state_dict`` takes
    converted JAX parameters (``models.convert.from_jax_params``). Then
    ``prefill``/``decode_step`` serve and ``apply`` runs the full-sequence
    forward. Caches are ``KVCache`` of (n_layers, B, L, KV, hd) tensors,
    written in place.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in _ATTENTION_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family (Mamba layers) is not "
                f"ported yet; see ROADMAP.md queue 1, falcon-mamba-7b "
                f"serving")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_stages = cfg.n_layers
        self.compute_dtype = dtype_of(cfg.dtype)
        self.param_dtype = dtype_of(cfg.param_dtype)
        dt, dev = self.param_dtype, self.device
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
        self.stages = nn.ModuleList(Stage(cfg, norm, dt, dev)
                                    for _ in range(self.n_stages))
        self.final_norm = norm()
        if not cfg.tie_embeddings:
            self.unembed = Dense(cfg.d_model, cfg.vocab_padded, dtype=dt,
                                 device=dev)
        self._weights = None

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Draw every parameter from ``generator`` (on the LM's device)."""
        def reset(module):
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
            else:
                for child in module.children():
                    reset(child)
        for child in self.children():
            reset(child)
        self._weights = None
        return self

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        self._weights = None
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def _apply(self, fn, *args, **kwargs):
        self._weights = None
        return super()._apply(fn, *args, **kwargs)

    def weights(self) -> dict:
        """The compute copy of the parameters, as the JAX package's nested
        dict (``stages`` a list of per-stage dicts)."""
        if self._weights is None:
            tree = _compute_copy(param_tree(self), self.compute_dtype)
            tree["stages"] = [tree["stages"][str(i)]
                              for i in range(self.n_stages)]
            self._weights = tree
        return self._weights

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

    def _ffn_apply(self, p, x):
        if "moe" in p:
            return moe_apply(p["moe"], x, self.cfg, mode=self.cfg.moe_mode)
        return (mlp_apply(p["mlp"], x, activation=self.cfg.activation),
                _zero_aux(x.device))

    def _embed(self, w, tokens, positions=None):
        cfg = self.cfg
        x = w["embed"]["w"][tokens].to(self.compute_dtype)
        if cfg.embed_scale != 1.0:
            x = x * torch.tensor(cfg.embed_scale, dtype=self.compute_dtype)
        if cfg.pos_embed == "sinusoidal":
            if positions is None:
                positions = torch.arange(tokens.shape[1], device=x.device)
            x = x + sinusoidal_positions(positions, cfg.d_model).to(
                self.compute_dtype)
        return x

    def _logits(self, w, x):
        if self.cfg.tie_embeddings:
            logits = x @ w["embed"]["w"].T
        else:
            logits = dense(w["unembed"], x, self.compute_dtype)
        return logits.float()

    def _as_long(self, t):
        return torch.as_tensor(t, device=self.device).long()

    # ------------------------------------------------------------------
    # forward passes
    # ------------------------------------------------------------------
    @torch.no_grad()
    def apply(self, tokens, *, prefix_embed=None):
        """tokens: (B, S) -> (logits (B, S', V) float32, aux). With a
        modality prefix the sequence is [prefix; tokens] and logits cover
        token positions."""
        w = self.weights()
        tokens = self._as_long(tokens)
        x = self._embed(w, tokens)
        n_prefix = 0
        if prefix_embed is not None:
            pe = torch.as_tensor(prefix_embed, device=self.device)
            pe = dense(w["prefix_proj"], pe.to(self.compute_dtype),
                       self.compute_dtype)
            x = torch.cat([pe, x], dim=1)
            n_prefix = pe.shape[1]
        b, s, _ = x.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        aux = _zero_aux(self.device)
        for sp, is_global in zip(w["stages"], self.stage_meta()):
            x = x + attn_train(sp["attn"], self._norm(sp["norm1"], x),
                               self.cfg, positions=positions,
                               is_global=is_global)
            h, a = self._ffn_apply(sp["ffn"], self._norm(sp["norm2"], x))
            x = x + h
            aux = {key: aux[key] + a[key] for key in aux}
        x = self._norm(w["final_norm"], x)
        if n_prefix:
            x = x[:, n_prefix:]
        return self._logits(w, x), aux

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """Zero KV caches (n_layers, batch, max_len, KV, hd) in
        ``kv_cache_dtype`` (or ``dtype``) on the LM's device."""
        cfg = self.cfg
        dt = dtype_of(cfg.kv_cache_dtype) if dtype is None else dtype
        shape = (self.n_stages, batch, max_len, cfg.n_kv_heads,
                 cfg.head_dim_)
        return KVCache(torch.zeros(shape, dtype=dt, device=self.device),
                       torch.zeros(shape, dtype=dt, device=self.device))

    @torch.no_grad()
    def prefill(self, cache: KVCache, tokens, lengths):
        """Process right-padded prompts and populate the cache.

        tokens: (B, S); lengths: (B,) real lengths (<= S <= cache max_len).
        Returns (last-token logits (B, V) float32, cache)."""
        w = self.weights()
        tokens = self._as_long(tokens)
        lengths = self._as_long(lengths)
        b, s = tokens.shape
        pos = torch.arange(s, device=self.device).expand(b, s)
        positions = torch.where(pos < lengths[:, None], pos, -1)
        x = self._embed(w, tokens)
        for i, (sp, is_global) in enumerate(zip(w["stages"],
                                                self.stage_meta())):
            h, _ = attn_prefill(sp["attn"], self._norm(sp["norm1"], x),
                                self.cfg, KVCache(cache.k[i], cache.v[i]),
                                positions=positions, is_global=is_global)
            x = x + h
            hf, _ = self._ffn_apply(sp["ffn"], self._norm(sp["norm2"], x))
            x = x + hf
        x = self._norm(w["final_norm"], x)
        last = x[torch.arange(b, device=self.device),
                 (lengths - 1).clamp_min(0)]               # (B, d)
        return self._logits(w, last), cache

    @torch.no_grad()
    def decode_step(self, cache: KVCache, tokens, lengths):
        """tokens: (B, 1) current token; lengths: (B,) its position.
        Returns (logits (B, 1, V) float32, cache)."""
        w = self.weights()
        tokens = self._as_long(tokens)
        lengths = self._as_long(lengths)
        x = self._embed(w, tokens, positions=lengths[:, None])
        for i, (sp, is_global) in enumerate(zip(w["stages"],
                                                self.stage_meta())):
            h, _ = attn_decode(sp["attn"], self._norm(sp["norm1"], x),
                               self.cfg, KVCache(cache.k[i], cache.v[i]),
                               lengths, is_global=is_global)
            x = x + h
            hf, _ = self._ffn_apply(sp["ffn"], self._norm(sp["norm2"], x))
            x = x + hf
        x = self._norm(w["final_norm"], x)
        return self._logits(w, x), cache
