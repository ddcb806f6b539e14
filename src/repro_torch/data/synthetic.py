"""Synthetic document stream: variable-length token sequences with the
paper's workload distributions (uniform / Poisson) plus Zipf for realistic
long-tail document lengths. Deterministic per (seed, index) so every host
can regenerate any shard without coordination."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DocStream", "Document"]


@dataclass(frozen=True)
class Document:
    doc_id: int
    tokens: np.ndarray   # (len,) int32


@dataclass(frozen=True)
class DocStream:
    vocab_size: int
    mean_len: int = 512
    max_len: int = 4096
    min_len: int = 16
    dist: str = "zipf"       # "uniform" | "poisson" | "zipf"
    seed: int = 0

    def _length(self, rng: np.random.Generator) -> int:
        if self.dist == "uniform":
            n = rng.integers(self.min_len, 2 * self.mean_len)
        elif self.dist == "poisson":
            n = self.min_len + rng.poisson(self.mean_len - self.min_len)
        elif self.dist == "zipf":
            # heavy tail, median well below mean (documents look like this)
            n = int(self.min_len + (rng.pareto(1.5) + 1) * self.mean_len / 3)
        else:
            raise ValueError(f"unknown length dist {self.dist!r}")
        return int(np.clip(n, self.min_len, self.max_len))

    def doc(self, index: int) -> Document:
        rng = np.random.default_rng((self.seed << 32) ^ index)
        n = self._length(rng)
        toks = rng.integers(0, self.vocab_size, size=n, dtype=np.int32)
        return Document(index, toks)

    def docs(self, start: int, count: int) -> list[Document]:
        return [self.doc(i) for i in range(start, start + count)]
