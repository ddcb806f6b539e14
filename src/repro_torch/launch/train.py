"""Training CLI, on the CUDA device unless ``--device cpu`` is given.

CPU-scale (smoke config):
  python -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu \\
      --steps 50 --rows 2 --seq-len 128 --ckpt-dir /tmp/ckpt

One card, full width:
  python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --steps 8 --rows 2 --seq-len 2048

On the production mesh (256 ranks, or 512 with ``multi``, one card each,
started by a launcher that sets each rank's environment):
  torchrun --nproc-per-node 8 --nnodes 32 ... \\
      -m repro_torch.launch.train --arch granite-moe-1b-a400m --mesh single

Prints one JSON line (``final_step``, ``first_loss``, ``final_loss``), as
``repro.launch.train`` does. The weights are drawn by ``LM.init`` from a
``torch.Generator`` seeded ``--seed`` on the device. With ``--mesh`` the
loop runs under ``set_mesh`` and the mesh's activation rules, as the
reference's does, and trains sharded (``train.sharded``): the LM is built
on meta and each rank draws the weights one leaf at a time, keeping its
shards.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import torch

from ..configs import get_config
from ..data import DocStream, Pipeline
from ..device import resolve_device
from ..models import LM
from ..models.common import dtype_of, logical_axis_rules
from .mesh import make_production_mesh, set_mesh
from .shardings import activation_rules
from ..optim import AdamW, warmup_cosine
from ..sched.straggler import StragglerMonitor
from ..train import LoopConfig, train

__all__ = ["main"]


def main(argv=None):
    """Parse ``argv``, train, print the JSON line; returns the history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rows", type=int, default=2,
                    help="batch rows per data shard")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--shards", type=int, default=2,
                    help="data shards for the pipeline")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA device (cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = None
    if args.mesh != "none":   # first: on cuda it picks each rank's card
        mesh = make_production_mesh(
            multi_pod=args.mesh == "multi",
            device_type=torch.device(args.device or "cuda").type)
    lm = LM(cfg, device=resolve_device(args.device),
            materialize=mesh is None)
    stream = DocStream(vocab_size=cfg.vocab_size,
                       mean_len=max(args.seq_len // 2, 16),
                       max_len=args.seq_len, seed=args.seed)
    monitor = StragglerMonitor(n_hosts=args.shards)
    pipe = Pipeline(stream, shard_dims=(args.shards,),
                    rows_per_shard=args.rows, seq_len=args.seq_len,
                    monitor=monitor)
    opt = AdamW(moments_dtype=dtype_of(cfg.moments_dtype))
    sch = warmup_cosine(args.lr, args.warmup, args.steps)
    loop = LoopConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed,
        microbatches=args.microbatches, log_every=args.log_every,
        metrics_hook=lambda step, row: print(
            f"step {step:5d} loss {row['loss']:.4f} "
            f"lr {row['lr']:.2e} dt {row['dt']*1e3:.0f}ms", flush=True))
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(set_mesh(mesh))
            stack.enter_context(logical_axis_rules(activation_rules(cfg,
                                                                    mesh)))
        state, history = train(lm, opt, sch, pipe, loop, monitor=monitor)
    print(json.dumps({"final_step": int(state.opt.step),
                      "first_loss": history[0]["loss"],
                      "final_loss": history[-1]["loss"]}))
    return history


if __name__ == "__main__":
    main()
