"""Rank functions of the port's multi-rank tests (run by
``_torch_ranks.run_ranks``, one per gloo rank). They import no JAX: the
tests compute the JAX side in their own process."""

from __future__ import annotations

import json
import weakref

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

SMALL_MESH = {False: ((4, 2), ("data", "model")),
              True: ((2, 2, 2), ("pod", "data", "model"))}


def small_production_mesh(*, multi_pod=False, ep=None, device_type="cuda"):
    """``make_production_mesh`` at 8 ranks, as the JAX package's tests
    patch it: (4, 2) ``("data", "model")``, (2, 2, 2) with ``pod``."""
    shape, axes = SMALL_MESH[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def patch_production_mesh():
    from repro_torch.launch import mesh, train
    mesh.make_production_mesh = small_production_mesh
    train.make_production_mesh = small_production_mesh


def axis_scans(rank, world, values):
    """Both ladders over an 8-rank axis, and the exclusive one over an
    axis of size 1."""
    from repro_torch.core import axis_exclusive_scan, axis_inclusive_scan
    x = torch.from_numpy(values[rank])
    line = init_device_mesh("cpu", (world,), mesh_dim_names=("x",))
    exc, total = axis_exclusive_scan(x, line, "x")
    inc, total2 = axis_inclusive_scan(x, line, "x")
    grid = init_device_mesh("cpu", (world, 1), mesh_dim_names=("x", "y"))
    one_exc, one_total = axis_exclusive_scan(x, grid, "y")
    return {k: v.numpy() for k, v in dict(
        exc=exc, total=total, inc=inc, total2=total2, one_exc=one_exc,
        one_total=one_total).items()}


def sharded_step(rank, world, arch, state_dict, batch, multi_pod, eps):
    """One sharded AdamW step of the smoke config from ``state_dict`` on
    the small production mesh: the gradients (gathered) before it, the
    metrics and the gathered parameters after it (rank 0), and every
    rank's bytes of parameter shards."""
    from repro_torch.launch import mesh as mesh_mod

    patch_production_mesh()
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    return step_on_mesh(rank, arch, state_dict, batch, mesh, eps)


def step_on_mesh(rank, arch, state_dict, batch, mesh, eps, changes=None,
                 watch=None):
    """``sharded_step`` on ``mesh`` (the smoke config with ``changes``);
    every rank also returns the compute's split over ``model``, and with
    ``watch`` (a dispatch mode made from the mesh, with a ``record()``)
    what it saw of the loss and gradients."""
    import contextlib
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shardings import activation_rules
    from repro_torch.models import LM
    from repro_torch.models.common import logical_axis_rules
    from repro_torch.models.distributed import gather_full
    from repro_torch.optim import AdamW, constant
    from repro_torch.optim.adamw import tree_items
    from repro_torch.train import make_train_step
    from repro_torch.train.sharded import gather_leaf, shard_state

    cfg = dataclasses.replace(get_config(arch).smoke(), **(changes or {}))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(state_dict)
    lm.requires_grad_(True)
    opt = AdamW(weight_decay=0.1, eps=eps)
    rules = activation_rules(cfg, mesh)
    with mesh_mod.set_mesh(mesh), logical_axis_rules(rules):
        state, sharding = shard_state(lm, opt, mesh, rules)
        step = make_train_step(lm, opt, constant(1e-3),
                               remat=True, clip_norm=0.5,
                               sharding=sharding)
        seen = watch(mesh) if watch else contextlib.nullcontext()
        with seen:
            _, _, grads = step.loss_grads(state.params, batch)
        grads = {".".join(path): gather_full(g, mesh, sharding.param[path])
                 for path, g in tree_items(grads)}
        local_bytes = sum(p.to_local().numel() * p.to_local().element_size()
                          for p in lm.parameters())
        state, metrics = step(state, batch)
        params = {".".join(path): gather_leaf(t)
                  for path, t in tree_items(state.params)}
        # the forward alone after the step: this rank's rows, the
        # vocabulary's columns gathered whole
        logits, _ = lm.apply(sharding.batch.rows(batch["tokens"]))
    split = sharding.split.flags()
    mine = {"local_param_bytes": local_bytes, "split": split}
    if watch:
        mine["watch"] = seen.record()
    out = {"grads": grads, "params": params,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "logits": logits, "step": int(state.opt.step), **mine}
    return out if rank == 0 else mine


def train_cli(rank, world, argv):
    """``launch.train.main(argv)`` on the small production mesh; the
    losses of its history and the JSON line it prints."""
    import contextlib
    import io

    from repro_torch.launch import train
    patch_production_mesh()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        history = train.main(argv)
    return {"losses": [row["loss"] for row in history],
            "line": json.loads(out.getvalue().strip().splitlines()[-1])}


def npz_arrays(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


class LiveBytes(TorchDispatchMode):
    """The bytes of the tensors made inside the block that are still
    alive, and their peak (``peak``), counted after each op: an output
    (a DTensor's local shard) that shares no storage with the op's inputs
    is new, and its bytes count until its storage is freed."""

    def __init__(self):
        super().__init__()
        self.now = self.peak = 0

    def _free(self, nbytes):
        self.now -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {_storage(t)._cdata for t in tree_leaves((args, kwargs))
                if _storage(t) is not None}
        for t in tree_leaves(out):
            st = _storage(t)
            if st is not None and st._cdata not in seen:
                seen.add(st._cdata)
                self.now += st.nbytes()
                weakref.finalize(st, self._free, st.nbytes())
        self.peak = max(self.peak, self.now)
        return out


def _storage(t):
    if isinstance(t, DTensor):
        t = t._local_tensor
    if isinstance(t, torch.Tensor) and not t.is_meta:
        return t.untyped_storage()
    return None


def _measured(fn, out: dict, key: str):
    """Run ``fn()``; record in ``out[key]`` the peak and the final bytes
    of the tensors it made (``LiveBytes``) and the peak growth of the
    Python heap (tracemalloc: numpy arrays, bytes)."""
    import tracemalloc
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    with LiveBytes() as live:
        result = fn()
    host = tracemalloc.get_traced_memory()[1] - base
    tracemalloc.stop()
    out[key] = {"peak": live.peak, "end": live.now, "host": host}
    return result


def sharded_memory(rank, world, arch, layers, ckpt_dir, batch):
    """A rank's memory on the (4, 2) mesh, per depth in ``layers``: the
    growth while ``shard_state`` draws the weights (LM built with
    ``materialize=False``), while one step's loss and gradients run, and
    while the state is saved and restored; the bytes of the largest leaf,
    of the largest stage, of the leaves outside the stages and of the
    whole model (float32), and of the rank's parameter shards; whether
    every shard equals ``LM.init``'s weights cut up, and every restored
    shard (params and moments) the saved one."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shardings import activation_rules
    from repro_torch.models import LM
    from repro_torch.models.common import logical_axis_rules
    from repro_torch.models.distributed import local_chunk
    from repro_torch.optim import AdamW, constant
    from repro_torch.optim.adamw import tree_items
    from repro_torch.train import make_train_step
    from repro_torch.train import sharded

    def shards(state):
        return {(i,) + path: t.to_local()
                for i, tree in enumerate((state.params, state.opt.m,
                                          state.opt.v))
                for path, t in tree_items(tree)}

    patch_production_mesh()
    mesh = mesh_mod.make_production_mesh(device_type="cpu")
    out = {}
    for n_layers in layers:
        cfg = dataclasses.replace(get_config(arch).smoke(),
                                  n_layers=n_layers)
        rules = activation_rules(cfg, mesh)
        opt = AdamW()
        rec = out[n_layers] = {}
        with mesh_mod.set_mesh(mesh), logical_axis_rules(rules):
            lm = LM(cfg, device="cpu", materialize=False).requires_grad_(
                True)
            whole = {n: p.numel() * 4 for n, p in lm.named_parameters()}
            rec["largest_leaf"] = max(whole.values())
            rec["whole"] = sum(whole.values())
            rec["outside"] = sum(v for n, v in whole.items()
                                 if not n.startswith("stages."))
            rec["largest_stage"] = max(
                sum(v for n, v in whole.items()
                    if n.startswith(f"stages.{i}."))
                for i in range(n_layers))
            gen = torch.Generator().manual_seed(0)
            state, sharding = _measured(
                lambda: sharded.shard_state(lm, opt, mesh, rules, gen), rec,
                "init")
            rec["shard_bytes"] = sum(
                p.to_local().numel() * p.to_local().element_size()
                for p in lm.parameters())
            ref = LM(cfg, device="cpu").init(
                torch.Generator().manual_seed(0))
            rec["init_equal"] = all(
                torch.equal(local_chunk(p.detach(), mesh,
                                        sharding.param[tuple(n.split("."))]),
                            lm.get_parameter(n).to_local())
                for n, p in ref.named_parameters())
            del ref
            step = make_train_step(lm, opt, constant(1e-3), remat=True,
                                   sharding=sharding)
            _measured(lambda: step.loss_grads(state.params, batch), rec,
                      "loss_grads")
            state, _ = step(state, batch)
            d = f"{ckpt_dir}/{n_layers}"
            _measured(lambda: sharded.save(d, 1, state), rec, "save")
            dist.barrier()
            saved = {k: t.clone() for k, t in shards(state).items()}
            with torch.no_grad():
                for t in shards(state).values():
                    t.zero_()
            _, state, _ = _measured(lambda: sharded.restore(d, state), rec,
                                    "restore")
            rec["restored"] = all(torch.equal(saved[k], t)
                                  for k, t in shards(state).items())
    return out
