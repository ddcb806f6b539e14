"""Multi-rank harness for the port's distributed tests: ``run_ranks`` starts
``world`` spawned processes, each a ``gloo`` rank of one process group on
a ``FileStore`` under the test's ``tmp_path`` (no TCP port), runs
``fn(rank, world, *args)`` in each and returns their results, rank by rank.
A rank that raises fails the test with its traceback; ranks still running
after ``timeout`` seconds are killed and fail it too.

``fn`` must be a module-level function of an importable module (the ranks
start from a fresh import); the rank functions of the tests live in
``tests/_torch_rank_fns.py``, which imports no JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback

__all__ = ["run_ranks"]


def _entry(fn, rank, world, store, out, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out, f"rank{rank}")
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(path + ".pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 120.0):
    out = tmp_path / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    out.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world,
                                              str(out / "store"), str(out),
                                              args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(out / f"rank{r}.err").read_text() for r in range(world)
              if (out / f"rank{r}.err").exists()]
    assert not errors, "\n".join(errors)
    assert not hung, f"ranks {hung} still ran after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results
