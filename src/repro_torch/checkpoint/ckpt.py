"""Checkpointing: save/restore of training-state trees with an async writer.

Format: one directory per step containing
  manifest.json — step, user metadata, and per leaf its shape, dtype and a
                  content hash (sha256[:16]) that restore validates
  arrays.npz    — the leaves, keyed by the JAX package's flattened paths

The keys and the bytes are the reference's (``src/repro/checkpoint/ckpt.py``):
a NamedTuple field is ``.<name>``, a dict key its name, joined by ``/``, and
the per-stage subtrees of the port (``stages: {"0": ..., "1": ...}``) are
stacked on a leading axis as the JAX package's stages are, so the port's
``arrays.npz`` of a converted state equals the JAX package's key for key and
hash for hash. The manifest is JSON, where the reference writes msgpack (the
standard library has JSON; the card machine has no msgpack). A bfloat16
leaf is stored as its uint16 bits, with dtype ``bfloat16`` in the manifest.

Writes go to ``<dir>/tmp.<step>`` and are atomically renamed, so a killed
writer never corrupts the latest checkpoint (restart-safety on preemption).
``save_async`` copies the state to the host at once and hands the writing to
a background thread, so the loop keeps stepping while it serialises.
``save`` and ``restore`` stream instead: one leaf (one stage of a stacked
key) at a time goes between the tree and the file, through an optional
``fetch`` on the way out and ``put`` on the way in — the sharded loop's
gather of a leaf's shards and its cut of a leaf into them
(``train.sharded``). ``keep_last`` prunes history.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import numpy.lib.format as npy
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "Checkpointer"]


def _join(path: str, part: str) -> str:
    return f"{path}/{part}" if path else part


def _walk(tree, fn, path="", stage=None, parent=None):
    """``tree`` with each leaf replaced by ``fn(key, stage, leaf)``: ``key``
    the leaf's flattened path in the JAX layout, ``stage`` its index in a
    per-stage ``stages`` dict (None elsewhere)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, name), fn,
                                  _join(path, "." + name), stage)
                            for name in tree._fields))
    if isinstance(tree, dict):
        if parent == "stages" and tree and all(str(k).isdigit()
                                               for k in tree):
            return {k: _walk(v, fn, path, int(k)) for k, v in tree.items()}
        return {k: _walk(v, fn, _join(path, str(k)), stage, k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(x, fn, _join(path, str(i)), stage)
                for i, x in enumerate(tree)]
    return fn(path, stage, tree)


def _host(leaf) -> np.ndarray:
    """A host copy of the leaf (a copy on the CPU too: the writer thread
    must not see the loop's in-place updates)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", memory_format=torch.contiguous_format,
                             copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _groups(tree) -> dict[str, dict]:
    """The leaves of ``tree`` by their key in the JAX layout: ``{stage:
    leaf}`` per key (stage None outside the per-stage subtrees)."""
    groups: dict[str, dict] = {}

    def visit(key, stage, leaf):
        groups.setdefault(key, {})[stage] = leaf

    _walk(tree, visit)
    return groups


def _entries(tree, fetch=None, host: bool = True):
    """Per leaf key of ``tree`` in sorted order: (key, dtype name, shape in
    the JAX layout, chunks). The chunks are the key's host arrays, one per
    stage in stage order (their bytes in order are the stacked array's),
    each made — through ``fetch(leaf)`` first if given — only when the
    iteration reaches it (without ``host``: the fetched tensors)."""
    def chunk(leaf):
        leaf = leaf if fetch is None else fetch(leaf)
        return _host(leaf) if host else leaf

    groups = _groups(tree)
    for key in sorted(groups):
        parts = groups[key]
        if None in parts:
            order, lead = [None], ()
        else:
            if sorted(parts) != list(range(len(parts))):
                raise ValueError(f"{key}: stages {sorted(parts)} are not "
                                 f"0..{len(parts) - 1}")
            order, lead = list(range(len(parts))), (len(parts),)
        first = parts[order[0]]
        yield (key, _dtype_name(first), lead + tuple(first.shape),
               (chunk(parts[i]) for i in order))


def _leaf_hash(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _write(directory: str, step: int, entries, metadata: dict | None,
           keep_last: int | None) -> str:
    """Write ``entries`` (``_entries``) as ``np.savez`` lays an npz out,
    each chunk appended to its key's member as it comes, and the
    manifest with each key's hash of those bytes."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    keys = {}
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, dtype, shape, chunks in entries:
            digest = hashlib.sha256()
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                for i, a in enumerate(chunks):
                    if i == 0:
                        npy.write_array_header_1_0(f, {
                            "descr": npy.dtype_to_descr(a.dtype),
                            "fortran_order": False, "shape": shape})
                    f.write(_bytes(a))
                    digest.update(_bytes(a))
                    del a           # before the next chunk is made
            keys[key] = {"shape": list(shape), "dtype": dtype,
                         "hash": digest.hexdigest()[:16]}
    manifest = {"step": step, "keys": keys, "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep_last:
        _prune(directory, keep_last)
    return final


def save(directory: str, step: int, tree, metadata: dict | None = None,
         keep_last: int | None = None, *, fetch=None, write: bool = True
         ) -> str | None:
    """Write ``tree`` one leaf at a time: each stage of a leaf is copied to
    the host (through ``fetch(leaf)`` first if given: a gather of a leaf's
    shards) and written before the next is fetched, so the host and the
    device hold one whole leaf at a time beyond ``tree`` itself. With
    ``write=False`` every leaf is fetched in the same order and nothing is
    written (the other ranks of a collective ``fetch``); returns None."""
    if not write:
        for _, _, _, chunks in _entries(tree, fetch, host=False):
            for _ in chunks:
                pass
        return None
    return _write(directory, step, _entries(tree, fetch), metadata,
                  keep_last)


def _prune(directory: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A tensor sharing ``arr``'s memory (a bfloat16 leaf from its bits)."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _read_into(f, arr: np.ndarray, digest) -> np.ndarray:
    """Fill ``arr`` with the next bytes of ``f`` (straight into its memory)
    and hash them."""
    flat = arr.reshape(-1).view(np.uint8)
    if f.readinto(flat) != flat.size:
        raise ValueError("truncated checkpoint member")
    digest.update(flat)
    return arr


def _member(zf: zipfile.ZipFile, raw, name: str):
    """``raw`` (the npz opened as a file) at the start of member ``name``'s
    bytes; ``np.savez`` stores them uncompressed, so they are read in
    place, with no reader's buffers between the file and the arrays."""
    info = zf.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{name}: compressed checkpoint member")
    raw.seek(info.header_offset)
    head = raw.read(30)                      # the member's local header
    names, extra = struct.unpack("<HH", head[26:30])
    raw.seek(info.header_offset + 30 + names + extra)
    return raw


_HEADERS = {(1, 0): npy.read_array_header_1_0,
            (2, 0): npy.read_array_header_2_0}


def restore(directory: str, tree_like, step: int | None = None,
            validate: bool = True, *, put=None):
    """Restore into the structure of ``tree_like`` (shape and dtype
    checked). Returns (step, tree, metadata): the tree of CPU tensors, or
    with ``put`` of ``put(leaf of tree_like, CPU tensor)``'s results.

    The leaves are read one at a time, each stage of a stacked key apart
    and straight into its array, and each goes to ``put`` before the next
    is read, so with a ``put`` that keeps what it needs (a shard) the host
    holds one leaf at a time.
    A key's hash is checked once all of its stages are read: on a corrupt
    checkpoint ``put`` has then seen that key's stages."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    groups = _groups(tree_like)
    loaded: dict[str, dict] = {}
    npz = os.path.join(path, "arrays.npz")
    with zipfile.ZipFile(npz) as zf, open(npz, "rb") as raw:
        for key in sorted(groups):
            parts = groups[key]
            if key not in manifest["keys"]:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            meta = manifest["keys"][key]
            f = _member(zf, raw, key + ".npy")
            shape, fortran, dtype = _HEADERS[npy.read_magic(f)](f)
            if list(shape) != meta["shape"] or fortran:
                raise ValueError(f"{key}: stored shape {shape} != "
                                 f"manifest")
            first = parts[None] if None in parts else parts[0]
            want_shape = tuple(first.shape)
            if None not in parts:
                want_shape = (len(parts),) + want_shape
            want_dtype = _dtype_name(first)
            if shape != want_shape or meta["dtype"] != want_dtype:
                raise ValueError(
                    f"{key}: ckpt {shape}/{meta['dtype']} != model "
                    f"{want_shape}/{want_dtype}")
            each = shape if None in parts else shape[1:]
            digest = hashlib.sha256()
            out = loaded[key] = {}
            for stage in ([None] if None in parts
                          else range(len(parts))):
                t = _to_tensor(_read_into(f, np.empty(each, dtype),
                                          digest), meta["dtype"])
                out[stage] = t if put is None else put(parts[stage], t)
                del t           # before the next stage is read
            if validate and digest.hexdigest()[:16] != meta["hash"]:
                raise ValueError(f"{key}: content hash mismatch "
                                 f"(corrupt ckpt)")
    tree = _walk(tree_like, lambda key, stage, leaf: loaded[key][stage])
    return manifest["step"], tree, manifest["metadata"]


class Checkpointer:
    """Async wrapper: one background writer, one in-flight save at a time
    (a second request waits — bounded memory)."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._lock = threading.Lock()
        self._last: Future | None = None

    def save_async(self, step: int, tree, metadata: dict | None = None
                   ) -> Future:
        entries = [(key, dtype, shape, list(chunks))    # device -> host now
                   for key, dtype, shape, chunks in _entries(tree)]
        with self._lock:
            if self._last is not None:
                self._last.result()  # backpressure
            self._last = self._pool.submit(
                _write, self.directory, step, entries, metadata,
                self.keep_last)
            return self._last

    def wait(self):
        with self._lock:
            if self._last is not None:
                self._last.result()

    def restore_latest(self, tree_like):
        self.wait()
        return restore(self.directory, tree_like)


def save_async(directory: str, step: int, tree, **kw) -> Future:
    return Checkpointer(directory).save_async(step, tree, **kw)
