"""Model configuration schema.

One frozen dataclass describes every assigned architecture (dense / MoE /
SSM / hybrid / modality-stub LM families). ``smoke()`` derives the reduced
config used by per-arch CPU smoke tests. Pure data, carried over whole from
the JAX package so that the two packages read one schema.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class ShapeSpec:
    """An assigned input-shape cell (seq_len x global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shape cells. decode_* and long_* lower serve_step
# (one new token against a seq_len KV cache), not train_step.
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 = attention-free)
    n_kv_heads: int
    d_ff: int                   # FFN hidden (per-expert hidden for MoE)
    vocab_size: int

    head_dim: int | None = None         # default d_model // n_heads
    qkv_bias: bool = False
    attn_logit_softcap: float | None = None
    pos_embed: str = "rope"             # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    sliding_window: int | None = None   # local-attention window
    global_every: int | None = None     # 1 global layer per this many (gemma3: 6)
    activation: str = "silu"            # silu | gelu | relu2
    mlp_gated: bool = True
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np
    tie_embeddings: bool = False
    embed_scale: float = 1.0            # gemma: sqrt(d_model)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1                  # MoE each N layers (jamba: 2)
    capacity_factor: float = 1.25
    psts_rebalance: bool = True         # the paper's technique (vs drop)
    moe_mode: str = "scatter"           # scatter | einsum (GShard baseline)
    dispatch_positions: str = "scan"    # scan (paper/Pallas) | sort (XLA opt)
    moe_layout_mode: str = "auto"       # auto (EP when divisible) | legacy
                                        # (FSDP d x TP ff — §Perf baseline)
    remat_policy: str = "nothing"       # nothing (full recompute) | outputs
                                        # (save attn/ffn outputs — trades
                                        # memory for one fwd recompute)

    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0                 # hybrid: 1 attn layer per N (jamba: 8)
    attn_offset: int = 3                # position of attn layer in the period

    # modality frontend stub ([audio]/[vlm]: precomputed embeddings)
    prefix_len: int = 0                 # frames/patches prepended at train
    prefix_dim: int = 0                 # frontend embedding width

    # long-context eligibility (sub-quadratic attention path exists)
    subquadratic: bool = False

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    moments_dtype: str = "float32"      # bf16 knob (grok-314B)
    kv_cache_dtype: str = "bfloat16"    # float8_e4m3fn: qwen's 40-head MHA
                                        # cache

    source: str = ""                    # provenance: [arXiv/hf; tier]

    # ---- derived ----------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (Megatron-style padding) so
        embed/unembed shard evenly over the model axis."""
        return -(-self.vocab_size // 256) * 256

    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    def n_params(self) -> int:
        """Parameter count (embeddings + stack), for roofline MODEL_FLOPS."""
        return self._total_params(active_only=False)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        return self._total_params(active_only=True)

    def _total_params(self, active_only: bool) -> int:
        d, ff = self.d_model, self.d_ff
        p = self.vocab_padded * d
        if not self.tie_embeddings:
            p += self.vocab_padded * d
        p += d  # final norm
        n_attn, n_ssm = self._layer_mix()
        # attention layers
        if self.n_heads:
            hd = self.head_dim_
            qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            o = self.n_heads * hd * d
            p += n_attn * (qkv + o)
        # ssm layers
        if self.is_ssm:
            di, st, dr = self.d_inner, self.ssm_state, self.dt_rank
            ssm = (2 * d * di            # in_proj (x, z)
                   + di * self.ssm_conv  # depthwise conv
                   + di * (dr + 2 * st)  # x_proj
                   + dr * di + di        # dt_proj
                   + di * st + di        # A_log, D
                   + di * d)             # out_proj
            p += n_ssm * ssm
        # ffn stack: ssm family has no separate FFN; all others have one
        # per layer, MoE replacing MLP every `moe_every` layers
        if self.family != "ssm":
            mlp = (3 if self.mlp_gated else 2) * d * ff
            if self.is_moe:
                n_moe = self.n_layers // self.moe_every
                n_dense = self.n_layers - n_moe
                router = d * self.n_experts
                e = self.experts_per_token if active_only else self.n_experts
                p += n_moe * (router + e * mlp) + n_dense * mlp
            else:
                p += self.n_layers * mlp
        # norms (2 per layer; 1 for pure-ssm layers)
        if self.norm_type != "layernorm_np":
            per_layer = 1 if self.family == "ssm" else 2
            p += self.n_layers * per_layer * d
        return p

    def _layer_mix(self) -> tuple[int, int]:
        """(n_attention_layers, n_ssm_layers)."""
        if self.family == "ssm":
            return 0, self.n_layers
        if self.family == "hybrid":
            n_attn = self.n_layers // self.attn_every
            return n_attn, self.n_layers - n_attn
        return self.n_layers, 0

    # ---- reduced config for CPU smoke tests -------------------------------
    def smoke(self) -> "ModelConfig":
        changes = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=(2 if self.n_kv_heads < self.n_heads else 4)
            if self.n_heads else 0,
            dtype="float32",
            param_dtype="float32",
            kv_cache_dtype="float32",
        )
        if self.is_moe:
            changes.update(n_experts=min(self.n_experts, 4),
                           experts_per_token=min(self.experts_per_token, 2))
        if self.is_ssm:
            changes.update(ssm_state=8)
        if self.family == "hybrid":
            changes.update(n_layers=min(self.n_layers, self.attn_every))
        if self.sliding_window:
            changes.update(sliding_window=16)
        if self.prefix_len:
            changes.update(prefix_len=8, prefix_dim=64)
        return replace(self, **changes)
