"""Optimizer substrate: AdamW over dicts of tensors, clipping, schedules,
int8 gradient compression with error feedback."""

from .adamw import AdamW, AdamWState, clip_by_global_norm, global_norm
from .compress import (
    CompressionState,
    compress,
    compress_with_feedback,
    decompress,
    init_state,
)
from .schedule import constant, warmup_cosine, warmup_rsqrt

__all__ = [
    "AdamW", "AdamWState", "clip_by_global_norm", "global_norm",
    "CompressionState", "compress", "compress_with_feedback", "decompress",
    "init_state", "constant", "warmup_cosine", "warmup_rsqrt",
]
