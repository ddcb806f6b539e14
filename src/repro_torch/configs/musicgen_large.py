"""musicgen-large [audio] — decoder-only LM over EnCodec tokens.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048. [arXiv:2306.05284; hf]
The EnCodec/conditioning frontend is a stub: ``input_specs()`` feeds
precomputed frame embeddings as a prefix (DESIGN.md section 7).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pos_embed="sinusoidal",
    activation="gelu",
    mlp_gated=False,
    norm_type="layernorm",
    prefix_len=256,          # conditioning frames (stub frontend)
    prefix_dim=768,
    source="[arXiv:2306.05284; hf]",
)
