"""qwen1.5-32b [dense] — MHA with QKV bias.

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064. [hf:Qwen/Qwen1.5; hf]
Notes: the JAX package chose an fp8 KV cache for this MHA model when it
sized serving for a TPU mesh; the port carries the value over unchanged.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    kv_cache_dtype="float8_e4m3fn",
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)
