"""Sequence packing with PSTS shard balancing.

Documents are assigned to data shards by ``sched.data_balance`` (power-
proportional work), then greedily packed into fixed (rows, seq_len) token
buffers per shard. Labels are next-token targets, -1 on padding and across
document boundaries (no cross-doc attention leakage in the loss; boundary
separation in attention itself would need a segment mask)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..sched.data_balance import balance_sequences
from .synthetic import Document

__all__ = ["PackedBatch", "pack_documents", "make_global_batch"]


@dataclass(frozen=True)
class PackedBatch:
    tokens: np.ndarray     # (rows, seq_len) int32
    labels: np.ndarray     # (rows, seq_len) int32, -1 = masked
    n_docs: int
    fill_ratio: float      # real tokens / capacity


def pack_documents(docs: list[Document], rows: int, seq_len: int,
                   pad_id: int = 0) -> PackedBatch:
    """First-fit packing of docs into ``rows`` buffers of ``seq_len``."""
    tokens = np.full((rows, seq_len), pad_id, dtype=np.int32)
    labels = np.full((rows, seq_len), -1, dtype=np.int32)
    cursor = np.zeros(rows, dtype=int)
    placed = 0
    for doc in sorted(docs, key=lambda d: -len(d.tokens)):
        n = len(doc.tokens)
        take = min(n, seq_len)
        fits = np.nonzero(cursor + take <= seq_len)[0]
        if fits.size == 0:
            continue
        r = fits[np.argmax(cursor[fits])]  # tightest fit first
        c = cursor[r]
        tokens[r, c:c + take] = doc.tokens[:take]
        # next-token labels within the doc; boundary token predicts nothing
        labels[r, c:c + take - 1] = doc.tokens[1:take]
        cursor[r] = c + take
        placed += 1
    fill = float(cursor.sum()) / (rows * seq_len)
    return PackedBatch(tokens, labels, placed, fill)


def make_global_batch(
    docs: list[Document],
    shard_dims: tuple[int, ...],
    rows_per_shard: int,
    seq_len: int,
    powers: np.ndarray | None = None,
):
    """PSTS-balance docs over shards, then pack each shard.

    Returns (global tokens (n_shards*rows, S), labels, per-shard stats).
    Shard i owns rows [i*rows_per_shard, (i+1)*rows_per_shard) — the caller
    shards axis 0 over (pod, data).
    """
    lengths = np.array([len(d.tokens) for d in docs])
    res = balance_sequences(lengths, shard_dims, powers=powers)
    n_shards = int(np.prod(shard_dims))
    tok_rows, lab_rows, stats = [], [], []
    for s in range(n_shards):
        mine = [d for d, dst in zip(docs, res.shard) if dst == s]
        pb = pack_documents(mine, rows_per_shard, seq_len)
        tok_rows.append(pb.tokens)
        lab_rows.append(pb.labels)
        stats.append({"docs": pb.n_docs, "fill": pb.fill_ratio,
                      "work": float(res.shard_work[s])})
    return (np.concatenate(tok_rows, axis=0),
            np.concatenate(lab_rows, axis=0), stats)
