"""falcon-mamba-7b [ssm] — attention-free Mamba-1 stack.

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16. [arXiv:2410.05355]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    pos_embed="none",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    subquadratic=True,
    source="[arXiv:2410.05355; unverified]",
)
