"""Training state: the LM's live parameters and the optimizer's state."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.common import param_tree
from ..optim.adamw import AdamW, AdamWState

__all__ = ["TrainState", "init_state"]


class TrainState(NamedTuple):
    """``params`` is ``param_tree(lm)``: the LM's own parameters (requiring
    grad), so an optimizer step that updates them in place updates the
    model."""
    params: Any
    opt: AdamWState

    @property
    def step(self):
        return self.opt.step


def init_state(lm, optimizer: AdamW,
               generator: torch.Generator | None = None) -> TrainState:
    """Draw the LM's parameters from ``generator`` (None keeps the ones it
    has, e.g. loaded ones), mark them trainable, and start the optimizer."""
    if generator is not None:
        lm.init(generator)
    lm.requires_grad_(True)
    params = param_tree(lm)
    return TrainState(params=params, opt=optimizer.init(params))
