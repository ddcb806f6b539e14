"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.

34L d_model=2560 8H (GQA kv=4, head_dim 256) d_ff=10240 vocab=262144,
sliding window 1024. [hf:google/gemma-3; unverified]
Simplification noted in DESIGN.md: one rope_theta for local+global layers.
"""

import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    sliding_window=1024,
    global_every=6,            # 5 local : 1 global
    activation="gelu",
    tie_embeddings=True,
    embed_scale=math.sqrt(2560.0),
    subquadratic=True,         # window attention: long_500k eligible
    source="[hf:google/gemma-3-1b-pt; unverified]",
)
