"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), each with a
``ctypes`` wrapper and a plain PyTorch version (``ref.py``); ``ops`` picks
one by the tensor's device:

  prefix_scan   — the paper's scan operator, one block per row with the
                  row total carried in a register
  psts_dispatch — the FIFO dispatch prefix, one accumulator per destination
"""

from . import ops, ref

__all__ = ["ops", "ref"]
