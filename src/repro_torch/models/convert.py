"""Parameters of the JAX package's LM as the port's state dict.

``from_jax_params(cfg, params)`` takes the JAX ``LM.init`` pytree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
state dict of ``repro_torch.models.LM(cfg)``: the keys join the dict keys
with dots, and every ``stages`` leaf, stacked on a leading ``n_stages`` axis
by the JAX package's ``jax.vmap(self._stage_init)``, is split into
``stages.<i>.<...>``: ``stages.<i>.mamba.*`` for ssm, and one stage per
period, ``stages.<i>.sub_<j>.{mixer, ffn, ...}.*``, for hybrid. No JAX is
imported: the arrays are plain numpy.

``jax_key(name)`` inverts the key mapping: the JAX path of a port
parameter, as the JAX package's sharding plans match it.

``from_jax_state(cfg, state)`` carries a JAX ``TrainState`` (params plus
``AdamWState(step, m, v)``, numpy leaves) over: the state dict, and the
optimizer state with its moments as nested dicts in ``param_tree`` layout
(``stages`` split into ``{"0": ..., "1": ...}``), as the port's AdamW keeps
them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params", "from_jax_state", "jax_key"]


def _flatten(tree, prefix: str, out: dict) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = np.asarray(val)


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' type: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_params(cfg, params) -> dict[str, torch.Tensor]:
    """The port's state dict for the JAX LM parameters ``params``."""
    n_stages = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                else cfg.n_layers)
    flat: dict[str, np.ndarray] = {}
    _flatten({k: v for k, v in params.items() if k != "stages"}, "", flat)
    stages: dict[str, np.ndarray] = {}
    _flatten(params["stages"], "", stages)
    state = {k: _tensor(v) for k, v in flat.items()}
    for key, stacked in stages.items():
        if stacked.shape[0] != n_stages:
            raise ValueError(f"stages.{key} has {stacked.shape[0]} stages, "
                             f"the config {n_stages}")
        for i in range(n_stages):
            state[f"stages.{i}.{key}"] = _tensor(stacked[i])
    return state


def jax_key(name: str) -> tuple[str, bool]:
    """``(path, stacked)`` of the port's state-dict key ``name``: the JAX
    parameter's path with its keys joined by ``/`` (``stages.<i>.<key>``,
    which :func:`from_jax_params` splits from the stacked ``stages/<key>``,
    maps back to that) and whether the JAX leaf carries the leading stage
    axis."""
    parts = name.split(".")
    if parts[0] == "stages":
        return "/".join(["stages", *parts[2:]]), True
    return "/".join(parts), False


def _nest(flat: dict) -> dict:
    """A dotted-key dict (a state dict) as nested dicts."""
    out: dict = {}
    for key, val in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val
    return out


def from_jax_state(cfg, state):
    """``(state_dict, AdamWState)`` of the JAX ``TrainState`` ``state``
    (``state.params``, ``state.opt.step``, ``.m``, ``.v`` as numpy arrays):
    the parameters as ``from_jax_params`` gives them, the step as a 0-d
    int32 tensor, the moments nested in ``param_tree`` layout, in their own
    dtype."""
    from ..optim.adamw import AdamWState
    opt = state.opt
    return from_jax_params(cfg, state.params), AdamWState(
        step=_tensor(opt.step).to(torch.int32).reshape(()),
        m=_nest(from_jax_params(cfg, opt.m)),
        v=_nest(from_jax_params(cfg, opt.v)))
