"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors the JAX package's layout and names, module for module, and is
held against it by the tests. It never imports ``jax`` or ``repro``.

Stable public API — the names most users need, re-exported here as the
JAX package does::

    from repro_torch import Scenario, run, sweep, RunResult  # offline lab
    from repro_torch import SchedulerService                  # online

The lab's batched sweeps run on the GPU::

    from repro_torch import lab
    results = lab.sweep(base=scenario, grid={"seed": range(128)})

and so does LM serving (attention, Mamba and hybrid families, PSTS MoE
dispatch, the request scheduler, the continuous-batching engine)::

    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m ...

The lab's CLI is ``python -m repro_torch.lab``. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions instead. Everything re-exports lazily
(PEP 562): ``import repro_torch`` imports neither numpy nor torch until a
name is touched.
"""

__version__ = "0.1.0"

# name -> providing submodule, resolved on first access
_PUBLIC_API = {
    "Scenario": "lab",
    "run": "lab",
    "sweep": "lab",
    "RunResult": "lab",
    "SchedulerService": "serve",
}

__all__ = ["__version__", *_PUBLIC_API]


def __getattr__(name):
    if name in _PUBLIC_API:
        import importlib
        mod = importlib.import_module(f".{_PUBLIC_API[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_PUBLIC_API))
