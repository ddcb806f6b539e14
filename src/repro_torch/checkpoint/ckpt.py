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
``keep_last`` prunes history.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
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


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """(arrays by key, dtype names by key) of ``tree`` in the JAX layout,
    per-stage leaves stacked in stage order."""
    groups: dict[str, dict] = {}

    def visit(key, stage, leaf):
        groups.setdefault(key, {})[stage] = leaf

    _walk(tree, visit)
    arrays, dtypes = {}, {}
    for key in sorted(groups):
        parts = groups[key]
        if None in parts:
            arrays[key] = _host(parts[None])
            dtypes[key] = _dtype_name(parts[None])
        else:
            if sorted(parts) != list(range(len(parts))):
                raise ValueError(f"{key}: stages {sorted(parts)} are not "
                                 f"0..{len(parts) - 1}")
            arrays[key] = np.stack([_host(parts[i])
                                    for i in range(len(parts))])
            dtypes[key] = _dtype_name(parts[0])
    return arrays, dtypes


def _leaf_hash(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _write(directory: str, step: int, arrays: dict, dtypes: dict,
           metadata: dict | None, keep_last: int | None) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                     "hash": _leaf_hash(v)} for k, v in arrays.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep_last:
        _prune(directory, keep_last)
    return final


def save(directory: str, step: int, tree, metadata: dict | None = None,
         keep_last: int | None = None) -> str:
    arrays, dtypes = _flatten(tree)
    return _write(directory, step, arrays, dtypes, metadata, keep_last)


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
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(directory: str, tree_like, step: int | None = None,
            validate: bool = True):
    """Restore into the structure of ``tree_like`` (shape and dtype
    checked). Returns (step, tree of CPU tensors, metadata)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    stages: dict[str, int] = {}

    def count(key, stage, leaf):
        stages[key] = stages.get(key, 0) + 1

    _walk(tree_like, count)
    loaded: dict[str, torch.Tensor] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def load(key, stage, leaf):
            if key not in loaded:
                if key not in manifest["keys"]:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = data[key]
                meta = manifest["keys"][key]
                if list(arr.shape) != meta["shape"]:
                    raise ValueError(f"{key}: stored shape {arr.shape} != "
                                     f"manifest")
                if validate and _leaf_hash(arr) != meta["hash"]:
                    raise ValueError(f"{key}: content hash mismatch "
                                     f"(corrupt ckpt)")
                want_shape = tuple(leaf.shape)
                if stage is not None:
                    want_shape = (stages[key],) + want_shape
                want_dtype = _dtype_name(leaf)
                if tuple(arr.shape) != want_shape or \
                        meta["dtype"] != want_dtype:
                    raise ValueError(
                        f"{key}: ckpt {arr.shape}/{meta['dtype']} != model "
                        f"{want_shape}/{want_dtype}")
                loaded[key] = _to_tensor(arr, meta["dtype"])
            t = loaded[key]
            return t if stage is None else t[stage]

        tree = _walk(tree_like, load)
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
        arrays, dtypes = _flatten(tree)  # device -> host now
        with self._lock:
            if self._last is not None:
                self._last.result()  # backpressure
            self._last = self._pool.submit(
                _write, self.directory, step, arrays, dtypes, metadata,
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
