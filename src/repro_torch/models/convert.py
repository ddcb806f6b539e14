"""Parameters of the JAX package's LM as the port's state dict.

``from_jax_params(cfg, params)`` takes the JAX ``LM.init`` pytree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
state dict of ``repro_torch.models.LM(cfg)``: the keys join the dict keys
with dots, and every ``stages`` leaf, stacked on a leading ``n_stages`` axis
by the JAX package's ``jax.vmap(self._stage_init)``, is split into
``stages.<i>.<...>``: ``stages.<i>.mamba.*`` for ssm, and one stage per
period, ``stages.<i>.sub_<j>.{mixer, ffn, ...}.*``, for hybrid. No JAX is
imported: the arrays are plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params"]


def _flatten(tree, prefix: str, out: dict) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = np.asarray(val)


def from_jax_params(cfg, params) -> dict[str, torch.Tensor]:
    """The port's state dict for the JAX LM parameters ``params``."""
    n_stages = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                else cfg.n_layers)
    flat: dict[str, np.ndarray] = {}
    _flatten({k: v for k, v in params.items() if k != "stages"}, "", flat)
    stages: dict[str, np.ndarray] = {}
    _flatten(params["stages"], "", stages)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in flat.items()}
    for key, stacked in stages.items():
        if stacked.shape[0] != n_stages:
            raise ValueError(f"stages.{key} has {stacked.shape[0]} stages, "
                             f"the config {n_stages}")
        for i in range(n_stages):
            state[f"stages.{i}.{key}"] = torch.from_numpy(
                np.array(stacked[i]))
    return state
