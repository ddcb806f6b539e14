"""The LM substrate of the port: layers (``nn.Module``s holding parameters
under the JAX package's keys, plain functions computing on them) and the
decoder ``LM`` for every family (attention, Mamba, hybrid)."""

from .attention import KVCache
from .convert import from_jax_params, from_jax_state
from .model import LM
from .ssm import Mamba, SSMCache

__all__ = ["LM", "KVCache", "Mamba", "SSMCache", "from_jax_params",
           "from_jax_state"]
