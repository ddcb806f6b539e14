"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), each with a
``ctypes`` wrapper and a plain PyTorch version (``ref.py``); ``ops`` picks
one by the tensor's device:

  prefix_scan   — the paper's scan operator, one block per row with the
                  row total carried in a register
  psts_dispatch — the FIFO dispatch prefix, one accumulator per destination,
                  and the MoE expert-dispatch positions, one counter per
                  expert, a block per token group
  flash_attention — causal GQA online-softmax attention, a block per
                  (batch, head, 64-query tile) walking only the KV tiles
                  its rows can see; bf16 on the tensor cores (mma.sync),
                  float32 on FMAs
  mamba_scan    — the selective scan of Mamba-1, a thread per few channels
                  of a (batch, state) row walking the sequence with h in
                  registers
"""

from . import ops, ref

__all__ = ["ops", "ref"]
