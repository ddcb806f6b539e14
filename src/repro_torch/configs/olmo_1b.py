"""olmo-1b [dense] — non-parametric LayerNorm.

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304. [arXiv:2402.00838; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="layernorm_np",
    tie_embeddings=True,
    source="[arXiv:2402.00838; hf]",
)
