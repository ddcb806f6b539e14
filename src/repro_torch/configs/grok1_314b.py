"""grok-1-314b [moe] — 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.
[hf:xai-org/grok-1; unverified]

``moments_dtype=bfloat16``: the JAX package sized its Adam moments for a
TPU mesh; the port carries the value over unchanged.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    attn_logit_softcap=30.0,
    activation="gelu",
    mlp_gated=True,
    n_experts=8,
    experts_per_token=2,
    moments_dtype="bfloat16",
    source="[hf:xai-org/grok-1; unverified]",
)
