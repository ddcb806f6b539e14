"""Data substrate: synthetic document stream, PSTS-balanced packing,
deterministic resumable pipeline. Host code (numpy), as in the JAX
package."""

from .packing import PackedBatch, make_global_batch, pack_documents
from .pipeline import Pipeline
from .synthetic import Document, DocStream

__all__ = ["PackedBatch", "make_global_batch", "pack_documents", "Pipeline",
           "Document", "DocStream"]
