"""Host data pipeline: deterministic document stream -> PSTS-balanced,
packed global batches, with straggler-adaptive shard powers.

Every step consumes a contiguous window of the document stream, so resuming
from a checkpoint at step k replays identically (the stream is a pure
function of (seed, index))."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..sched.straggler import StragglerMonitor
from .packing import make_global_batch
from .synthetic import DocStream

__all__ = ["Pipeline"]


@dataclass
class Pipeline:
    stream: DocStream
    shard_dims: tuple[int, ...]     # e.g. (pods, data_shards)
    rows_per_shard: int
    seq_len: int
    docs_per_step: int | None = None
    monitor: StragglerMonitor | None = field(default=None)

    def __post_init__(self):
        if self.docs_per_step is None:
            # oversample so packing fills rows even with long docs
            n_shards = int(np.prod(self.shard_dims))
            budget = n_shards * self.rows_per_shard * self.seq_len
            self.docs_per_step = max(1, int(
                budget / max(self.stream.mean_len, 1) * 0.9))

    def batch(self, step: int):
        """Returns {"tokens": (B, S) int32, "labels": (B, S) int32} plus
        per-shard stats. B = prod(shard_dims) * rows_per_shard."""
        start = step * self.docs_per_step
        docs = self.stream.docs(start, self.docs_per_step)
        powers = self.monitor.powers() if self.monitor else None
        tokens, labels, stats = make_global_batch(
            docs, self.shard_dims, self.rows_per_shard, self.seq_len,
            powers=powers)
        return {"tokens": tokens, "labels": labels}, stats
