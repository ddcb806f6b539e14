"""The LM substrate of the port: layers (``nn.Module``s holding parameters
under the JAX package's keys, plain functions computing on them) and the
decoder ``LM`` for the attention families."""

from .convert import from_jax_params
from .model import LM

__all__ = ["LM", "from_jax_params"]
