"""Checkpoint substrate: atomic save/restore of training-state trees in the
JAX package's layout, async writer."""

from .ckpt import Checkpointer, latest_step, restore, save, save_async

__all__ = ["Checkpointer", "latest_step", "restore", "save", "save_async"]
