"""Multi-pod dry run: every (architecture x input-shape x mesh) cell's step
on the production mesh with no card and no allocation, and its memory,
cost and collective record.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \\
      --mesh single --out experiments/dryrun
  python -m repro_torch.launch.dryrun --all --mesh both

A cell sets up a one-process world of 256 (or 512) ranks on
``torch.distributed``'s ``fake`` backend (collectives return at once),
builds the production ``DeviceMesh`` on it and the LM on the ``meta``
device, places the state by the sharding plans (``train.sharded``) and
runs rank 0's step — the sharded train step, or ``prefill`` /
``decode_step`` on bf16 weights — on meta tensors, so nothing is computed
or allocated. A plan that does not divide, a placement that does not fit
or a step that does not trace fails the cell.

The record has the JAX package's keys (``src/repro/launch/dryrun.py``):
  * ``memory.args_bytes``: what one rank holds as the step's arguments —
    the DTensors' local shards of the state (params and AdamW moments and
    step, or bf16 params and the KV/SSM cache) plus its rows of the
    inputs; ``state_bytes`` is the state's part. ``output_bytes`` are the
    step's outputs on that rank, ``alias_bytes`` those that update an
    argument in place (the state; the cache); ``temp_bytes`` is not
    measured (a meta run allocates nothing).
  * ``cost.flops``: the step's FLOPs on one rank, counted exactly by
    ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, attention's
    included; elementwise ops count none). The stage loop is a Python
    loop, so every stage is counted and the JAX package's fit over 1- and
    2-stage lowerings (``_analysis_counts``) is not needed: ``corrected``
    holds the same exact counts. ``cost.bytes_accessed``: the bytes every
    op but views reads and writes.
  * ``collectives``: the collectives the step issues, recorded as it runs
    (kind, result shape, dtype, group size) and priced by
    ``roofline.collective_stats`` — in place of parsing HLO text.
  * ``lower_s``: seconds to build and place the state; ``compile_s``:
    seconds of the counted step.

The train cells compute each model-axis rank's share of its rows
(``models.distributed``'s split: heads, ff columns, experts, vocabulary
columns, Mamba channels; a dim the plans leave whole, such as granite's 8
KV heads on 16 ranks, is computed on every rank), so their FLOPs and the
activations' all-reduces over ``model`` are the split step's. The serve
cells gather every weight whole and run on the rank's rows of the cache at
its full length (the cache's sequence split over ``model`` counts in its
bytes; the port has no sequence-parallel attention), so their
``useful_compute_ratio`` stays about 1 / the model axis's size.

Import this module only to run a cell: it starts the fake world itself
(``torch.testing._internal.distributed.fake_pg``), never at import.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, arch_shape_cells, get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..models import LM
from ..models.common import dtype_of, logical_axis_rules
from ..models.distributed import local_chunk, to_local
from ..optim import AdamW, warmup_cosine
from ..optim.adamw import tree_leaves
from ..train import make_train_step
from ..train.sharded import shard_params, shard_state
from .mesh import make_production_mesh, set_mesh
from .roofline import collective_stats, roofline_report
from .shardings import activation_rules, cache_pspecs, placements

__all__ = ["input_specs", "lower_cell", "main"]

_KINDS = {"allreduce_": "all-reduce", "allgather_": "all-gather",
          "_allgather_base_": "all-gather",
          "allgather_into_tensor_coalesced_": "all-gather",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
          "send": "collective-permute", "recv_": "collective-permute"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class _Recorder(TorchDispatchMode):
    """Records the collectives a step issues and sums the bytes its ops
    read and write (ops on plain tensors: a DTensor op is counted through
    the local ops it runs)."""

    def __init__(self):
        super().__init__()
        self.collectives: list[dict] = []
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            name = func._opname
            group = [a for a in args if isinstance(a, torch.ScriptObject)]
            size = (dist.ProcessGroup.unbox(group[0]).size() if group
                    else 1)
            result = args[0]          # the written tensors
            first = result
            while isinstance(first, (list, tuple)):
                first = first[0]
            self.collectives.append({
                "kind": _KINDS.get(name, name), "bytes": _nbytes(result),
                "shape": list(first.shape), "dtype": str(first.dtype),
                "group": size})
        elif all(t is torch.Tensor for t in types) and not func.is_view:
            self.bytes += _nbytes(list(args)) + _nbytes(
                list(out) if isinstance(out, (tuple, list)) else out)
        return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """(shape, dtype) of every model input of this cell (the whole
    batch)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": ((b, s), torch.int32),
                 "labels": ((b, s), torch.int32)}
        if cfg.prefix_len:
            specs["prefix_embed"] = ((b, cfg.prefix_len, cfg.prefix_dim),
                                     dtype_of(cfg.dtype))
        return specs
    if shape.kind == "prefill":
        return {"tokens": ((b, s), torch.int32),
                "lengths": ((b,), torch.int32)}
    # decode: one new token against a seq_len cache
    return {"tokens": ((b, 1), torch.int32), "lengths": ((b,), torch.int32)}


def _meta(spec):
    return torch.zeros(spec[0], dtype=spec[1], device="meta")


def _local_bytes(tree) -> int:
    """Bytes of the local shards (plain tensors: themselves)."""
    return sum(_nbytes(to_local(t)) for t in tree_leaves(tree))


def _lower_one(cfg: ModelConfig, shape: ShapeSpec, multi_pod: bool,
               ep: int | None = None) -> dict:
    """Place and run one cell on the fake world (which must be up)."""
    mesh = make_production_mesh(multi_pod=multi_pod, ep=ep,
                                device_type="cpu")
    n_dev = mesh.size()
    rules = activation_rules(cfg, mesh, shape)
    t0 = time.perf_counter()
    lm = LM(cfg, device="meta")
    with set_mesh(mesh), logical_axis_rules(rules):
        inputs = {k: _meta(v) for k, v in input_specs(cfg, shape).items()}
        if shape.kind == "train":
            opt = AdamW(moments_dtype=dtype_of(cfg.moments_dtype))
            lm.requires_grad_(True)
            state, sharding = shard_state(lm, opt, mesh, rules)
            rows = {k: sharding.batch.rows(v) for k, v in inputs.items()}
            state_bytes = (_local_bytes(state.params)
                           + _local_bytes(state.opt.m)
                           + _local_bytes(state.opt.v)
                           + _nbytes(state.opt.step))
            step = make_train_step(lm, opt,
                                   warmup_cosine(3e-4, 100, 10_000),
                                   remat=True, sharding=sharding)

            def run():
                return step(state, inputs)
        else:
            lm.to(torch.bfloat16)        # serving holds bf16 weights
            sharding = shard_params(lm, mesh, rules)
            whole = lm.init_cache(shape.global_batch, shape.seq_len)
            specs = cache_pspecs(whole, cfg, mesh, shape)
            cache_bytes = sum(
                _nbytes(local_chunk(t, mesh, placements(mesh, s)))
                for t, s in zip(_leaves(whole), _leaves(specs)))
            state_bytes = _local_bytes(dict(lm.named_parameters())) \
                + cache_bytes
            rows = {k: sharding.batch.rows(v) for k, v in inputs.items()}
            cache = lm.init_cache(rows["tokens"].shape[0], shape.seq_len)
            fn = lm.prefill if shape.kind == "prefill" else lm.decode_step

            def run():
                return fn(cache, rows["tokens"], rows["lengths"])
        t_lower = time.perf_counter() - t0
        rec = _Recorder()
        with FlopCounterMode(display=False) as flops, rec:
            out = run()
        t_step = time.perf_counter() - t0 - t_lower
    in_bytes = _nbytes(list(rows.values()))
    if shape.kind == "train":
        alias = state_bytes
        out_bytes = state_bytes + _nbytes(list(out[1].values()))
    else:
        alias = cache_bytes
        out_bytes = cache_bytes + _nbytes(out[0])
    coll = collective_stats(rec.collectives)
    cost = {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(rec.bytes)}
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "kind": shape.kind,
        "n_stages": lm.n_stages,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_step, 1),
        "memory": {
            "args_bytes": state_bytes + in_bytes,
            "state_bytes": state_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "alias_bytes": alias,
        },
        "cost": cost,
        "collectives": coll,
        "corrected": {"flops": cost["flops"],
                      "bytes_accessed": cost["bytes_accessed"],
                      "collective_bytes": float(coll["total_bytes"]),
                      "collective_count": float(coll["total_count"])},
        "collective_log": rec.collectives,
    }


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg: ModelConfig | None = None, ep: int | None = None
               ) -> dict:
    """The dry-run record of one cell, with its roofline terms. Starts the
    fake world of the mesh's size and ends it again."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        record = _lower_one(cfg, shape, multi_pod, ep=ep)
    finally:
        dist.destroy_process_group()
    if ep:
        record["mesh"] += f"+ep{ep}"
    record["roofline"] = roofline_report(record, cfg, shape)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    cells = []
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        for arch, shape_name, skipped in arch_shape_cells():
            for mp in meshes:
                cells.append((arch, shape_name, mp))
    else:
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag} (cached)")
            continue
        print(f"[run ] {tag}", flush=True)
        try:
            rec = lower_cell(arch, shape_name, mp)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            r = rec["roofline"]
            state_gib = rec["memory"]["args_bytes"] / 2 ** 30
            print(f"      ok: step={rec['compile_s']}s "
                  f"state/dev={state_gib:.2f}GiB "
                  f"dominant={r['dominant']} "
                  f"t_compute={r['compute_s']:.4f}s "
                  f"t_mem={r['memory_s']:.4f}s "
                  f"t_coll={r['collective_s']:.4f}s "
                  f"roofline={r['roofline_fraction']:.3f}", flush=True)
        except Exception:
            failures += 1
            print(f"      FAILED {tag}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
