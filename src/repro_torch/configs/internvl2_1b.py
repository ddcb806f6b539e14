"""internvl2-1b [vlm] — Qwen2-0.5B language backbone; InternViT frontend is
a stub feeding precomputed patch embeddings as a prefix.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. [arXiv:2404.16821; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    qkv_bias=True,
    tie_embeddings=True,
    prefix_len=256,           # ViT patch tokens (stub frontend)
    prefix_dim=1024,          # InternViT-300M width
    source="[arXiv:2404.16821; hf]",
)
