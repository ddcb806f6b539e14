"""Streaming, chunked trace ingestion.

Real cluster traces are large (the Google cluster-data task-events table is
millions of rows, usually gzipped), so parsers never load a file as Python
objects row-by-row. The pipeline here is:

1. :func:`iter_text_chunks` — read the file (gzip transparently, detected by
   magic bytes, not extension) in large byte chunks aligned to line
   boundaries,
2. :func:`iter_numeric_chunks` — turn each chunk into a ``(rows, cols)``
   float64 array with ``np.loadtxt`` (C fast path), empty CSV fields
   becoming NaN so optional columns survive,
3. parsers concatenate per-chunk column selections and run vectorized joins.

A million-row file ingests in a few seconds on one core; nothing is ever
materialized as per-row Python tuples.
"""

from __future__ import annotations

import gzip
import io
import warnings

import numpy as np

__all__ = ["open_maybe_gzip", "iter_text_chunks", "iter_numeric_chunks",
           "read_numeric_csv"]

_GZIP_MAGIC = b"\x1f\x8b"


def open_maybe_gzip(path):
    """Binary handle, gunzipping transparently (magic bytes, not suffix)."""
    fh = open(path, "rb")
    magic = fh.read(2)
    fh.seek(0)
    if magic == _GZIP_MAGIC:
        return gzip.open(fh, "rb")
    return fh


def iter_text_chunks(path, *, chunk_bytes: int = 1 << 24):
    """Yield decoded text chunks that always end on a line boundary."""
    with open_maybe_gzip(path) as fh:
        carry = b""
        while True:
            block = fh.read(chunk_bytes)
            if not block:
                if carry.strip():
                    yield carry.decode()
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            carry = block[cut + 1:]
            yield block[:cut + 1].decode()


def _fill_empty_fields(text: str) -> str:
    """Empty CSV fields -> ``nan`` so ``np.loadtxt`` accepts sparse columns
    (Google task events leave resource requests blank for some rows)."""
    if ",," in text or ",\n" in text or text.startswith(","):
        while ",," in text:
            text = text.replace(",,", ",nan,")
        text = text.replace(",\n", ",nan\n")
        if text.startswith(","):
            text = "nan" + text
        if text.endswith(","):
            text += "nan"
    return text


def iter_numeric_chunks(path, *, usecols, chunk_bytes: int = 1 << 24,
                        delimiter: str = ","):
    """Yield ``(rows, len(usecols))`` float64 arrays per chunk.

    Non-numeric columns (Google's obfuscated user/job-name strings) are
    tolerated as long as they are not listed in ``usecols`` —
    ``np.loadtxt`` splits every line but only converts the requested
    columns. Comment lines (``#``) and blank lines are skipped.
    """
    usecols = tuple(int(c) for c in usecols)
    for text in iter_text_chunks(path, chunk_bytes=chunk_bytes):
        text = _fill_empty_fields(text)
        with warnings.catch_warnings():
            # comment-only chunks are fine, not a user-facing warning
            warnings.filterwarnings("ignore",
                                    message=".*input contained no data.*")
            arr = np.loadtxt(io.StringIO(text), delimiter=delimiter,
                             comments="#", usecols=usecols, ndmin=2,
                             dtype=np.float64)
        if arr.size:
            yield arr


def read_numeric_csv(path, *, usecols, chunk_bytes: int = 1 << 24
                     ) -> np.ndarray:
    """All chunks concatenated: ``(total_rows, len(usecols))`` float64."""
    chunks = list(iter_numeric_chunks(path, usecols=usecols,
                                      chunk_bytes=chunk_bytes))
    if not chunks:
        return np.zeros((0, len(tuple(usecols))), dtype=np.float64)
    return np.concatenate(chunks, axis=0)
