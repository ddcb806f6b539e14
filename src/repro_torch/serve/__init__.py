"""Serving: the continuous-batching token-serving engine. The scheduler
service and its task sources come with a later slice of the port."""

from .engine import Engine, GenRequest

__all__ = ["Engine", "GenRequest"]
