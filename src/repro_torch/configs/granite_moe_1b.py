"""granite-moe-1b-a400m [moe] — 32 experts top-8 (strongest routing
imbalance of the pool: the PSTS-dispatch flagship).

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per-expert) vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    tie_embeddings=True,
    n_experts=32,
    experts_per_token=8,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)
