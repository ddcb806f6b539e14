"""Probe: does this torch's gloo backend take CUDA tensors for every
collective the split train step issues, with two ranks sharing one card?

    python experiments/torch_gloo_cuda_probe.py --out gloo_probe.json

Two spawned processes form a gloo world on a ``FileStore`` (no TCP port),
both on ``cuda:0``, and run each collective of ``models.distributed`` and
``train.sharded`` on CUDA tensors: all-reduce (sum, max), all-gather (list
and into one tensor), reduce-scatter (into one tensor), broadcast and a
barrier, in float32 and bfloat16, first on the default group and then on
the ``model`` group of a (1, 2) ``("data", "model")`` ``DeviceMesh``. Each
result is checked against the values the ranks put in; each op is timed
over a few calls at two sizes (host clock around ``synchronize``). Then
the same ops run on the threaded process group
(``torch.testing._internal.distributed.multi_threaded_pg``: two threads of
one process) as the fallback. Writes every op's verdict and time to
``--out`` as JSON and prints one line a op.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import tempfile
import threading
import time
import traceback

SIZES = (1 << 12, 1 << 22)      # elements: a small tensor, 16 MB in f32
REPS = 5


def _ops(dist, torch, group, rank, world, dev):
    """(name, dtype, n) -> {"ok": bool, "ms": float | None, "error": str}"""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in SIZES:
            def base():
                return torch.arange(n, device=dev, dtype=torch.float32).to(
                    dtype) * 0 + (rank + 1)

            def all_reduce_sum():
                t = base()
                dist.all_reduce(t, group=group)
                return bool((t == sum(range(1, world + 1))).all())

            def all_reduce_max():
                t = base()
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
                return bool((t == world).all())

            def all_gather_list():
                parts = [torch.empty(n, device=dev, dtype=dtype)
                         for _ in range(world)]
                dist.all_gather(parts, base(), group=group)
                return all(bool((p == i + 1).all())
                           for i, p in enumerate(parts))

            def all_gather_tensor():
                t = torch.empty(world * n, device=dev, dtype=dtype)
                dist.all_gather_into_tensor(t, base(), group=group)
                return all(bool((c == i + 1).all())
                           for i, c in enumerate(t.chunk(world)))

            def reduce_scatter_tensor():
                src = torch.cat([base() * (i + 1) for i in range(world)])
                t = torch.empty(n, device=dev, dtype=dtype)
                dist.reduce_scatter_tensor(t, src, group=group)
                want = (rank + 1) * sum(range(1, world + 1))
                return bool((t == want).all())

            def broadcast():
                t = base()
                dist.broadcast(t, src=dist.get_global_rank(group, 0)
                               if group is not None else 0, group=group)
                return bool((t == 1).all())

            for fn in (all_reduce_sum, all_reduce_max, all_gather_list,
                       all_gather_tensor, reduce_scatter_tensor, broadcast):
                key = f"{fn.__name__} {str(dtype)[6:]} {n}"
                try:
                    ok = fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(REPS):
                        fn()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / REPS
                    out[key] = {"ok": ok, "ms": ms, "error": ""}
                except Exception as exc:      # a verdict, not a crash
                    out[key] = {"ok": False, "ms": None,
                                "error": f"{type(exc).__name__}: "
                                         f"{str(exc)[:300]}"}
    try:
        dist.barrier(group=group)
        out["barrier"] = {"ok": True, "ms": None, "error": ""}
    except Exception as exc:
        out["barrier"] = {"ok": False, "ms": None,
                          "error": f"{type(exc).__name__}: {exc}"[:300]}
    return out


def _rank(rank, world, store, path):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        res["default"] = _ops(dist, torch, None, rank, world, dev)
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        res["mesh_model"] = _ops(dist, torch, mesh.get_group("model"), rank,
                                 world, dev)
        dist.destroy_process_group()
    except Exception:
        res["error"] = traceback.format_exc()
    with open(f"{path}.{rank}", "w") as f:
        json.dump(res, f)


def _threaded(world):
    """The same ops on the threaded process group, ranks as threads."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mt

    dev = torch.device("cuda", 0)
    results = [None] * world
    store = dist.HashStore()
    mt._install_threaded_pg()
    # each thread its own registry of process groups, as torch's threaded
    # tests set it
    torch._C._distributed_c10d._set_thread_isolation_mode(True)

    def body(rank):
        try:
            dist.init_process_group("threaded", rank=rank, world_size=world,
                                    store=store)
            results[rank] = {"default": _ops(dist, torch, None, rank, world,
                                             dev)}
            dist.destroy_process_group()
        except Exception:
            results[rank] = {"error": traceback.format_exc()}
    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch._C._distributed_c10d._set_thread_isolation_mode(False)
    mt._uninstall_threaded_pg()
    return [r if r is not None else {"error": "hung"} for r in results]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="gloo_probe.json")
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "res")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, args.world,
                                                 os.path.join(tmp, "store"),
                                                 path))
                 for r in range(args.world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        hung = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r in range(args.world):
            try:
                with open(f"{path}.{r}") as f:
                    ranks.append(json.load(f))
            except FileNotFoundError:
                ranks.append({"error": "no result"})
        gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    threaded = _threaded(args.world)
    threaded_s = time.perf_counter() - t0
    record = {"torch": torch.__version__,
              "device": torch.cuda.get_device_name(0),
              "gloo": ranks, "gloo_hung": hung, "gloo_s": gloo_s,
              "threaded": threaded, "threaded_s": threaded_s}
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    for name, per_rank in (("gloo", ranks), ("threaded", threaded)):
        for r, res in enumerate(per_rank):
            if "error" in res:
                print(f"{name} rank {r}: {res['error']}")
        for where, ops in per_rank[0].items():
            if not isinstance(ops, dict):
                continue
            for op, v in ops.items():
                ok = all(isinstance(p.get(where), dict)
                         and p[where].get(op, {}).get("ok") for p in per_rank)
                ms = v["ms"]
                print(f"{name} {where} {op}: {'ok' if ok else 'FAIL'}"
                      f"{'' if ms is None else f' {ms:.3f} ms'} "
                      f"{v['error']}")
    print(f"gloo {gloo_s:.1f}s (hung: {hung}), threaded {threaded_s:.1f}s")


if __name__ == "__main__":
    main()
