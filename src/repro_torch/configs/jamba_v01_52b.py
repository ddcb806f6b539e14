"""jamba-v0.1-52b [hybrid] — Mamba + attention 7:1 interleave, MoE 16e top-2
every other layer.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, ssm_state=16.
[arXiv:2403.19887; hf]
Period structure (attn_every=8): sub-layers 0..7 are Mamba except the
attention mixer at offset 3; MoE replaces the MLP on odd sub-layers.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    attn_every=8,
    attn_offset=3,
    subquadratic=True,
    source="[arXiv:2403.19887; hf]",
)
