"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors the JAX package's layout and names, module for module, and is
held against it by the tests. It never imports ``jax`` or ``repro``.

Ported so far: the batched PSTS engine and its lab entry points::

    from repro_torch import lab
    results = lab.sweep(base=scenario, grid={"seed": range(128)})

and LM serving (attention, Mamba and hybrid families, PSTS MoE dispatch,
the request scheduler, the continuous-batching engine)::

    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m ...

Entry points run on the CUDA device unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions instead.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
