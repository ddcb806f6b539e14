"""Host training loop: data pipeline -> train step -> checkpoint/restart,
with straggler monitoring feeding PSTS data balancing — the paper's
operating loop around a training job.

Fault tolerance:
  * async checkpoint every ``ckpt_every`` steps (atomic rename, keep_last),
  * SIGTERM/SIGINT -> synchronous final checkpoint before exit (preemption),
  * resume: restores the latest checkpoint into the live state and replays
    the deterministic data stream from that step.

Each step's ``dt`` waits on the device: the loss is read back (``.item()``)
before the clock stops.

Under a mesh bound with ``launch.mesh.set_mesh`` the loop trains sharded
(``train.sharded``), the batch's ranks from the ``logical_axis_rules``
bound with it: the weights are drawn on every rank from the same seed one
leaf at a time, each cut to the rank's shard before the next (build the
LM with ``materialize=False`` so that it holds nothing whole first);
checkpoints are written one gathered leaf at a time by rank 0, in the
loop's thread, and a resume reads one leaf at a time into the shards.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.ckpt import Checkpointer, latest_step, restore
from ..data.pipeline import Pipeline
from ..launch.mesh import current_mesh
from ..models.common import current_rules
from ..optim.adamw import AdamW, AdamWState
from ..sched.straggler import StragglerMonitor
from . import sharded
from .state import TrainState, init_state
from .step import make_train_step

__all__ = ["LoopConfig", "train"]


@dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    seed: int = 0
    remat: bool = True
    clip_norm: float = 1.0
    microbatches: int = 1
    metrics_hook: object = None   # callable(step, metrics_dict)
    history: list = field(default_factory=list)


@torch.no_grad()
def _load_into(state: TrainState, restored: TrainState) -> TrainState:
    """Copy a restored state into the live tensors (the LM's parameters
    stay the model's)."""
    def copy(live, saved):
        if isinstance(live, dict):
            for key in live:
                copy(live[key], saved[key])
        else:
            live.copy_(saved)
    copy(state.params, restored.params)
    copy(state.opt.m, restored.opt.m)
    copy(state.opt.v, restored.opt.v)
    return TrainState(state.params, AdamWState(
        step=restored.opt.step.to(torch.int32).reshape(()),
        m=state.opt.m, v=state.opt.v))


def train(lm, optimizer: AdamW, lr_schedule, pipeline: Pipeline,
          cfg: LoopConfig, *, monitor: StragglerMonitor | None = None):
    """Run the loop on ``lm``'s device, its weights drawn from a generator
    seeded ``cfg.seed``, sharded over the bound mesh if there is one;
    returns (final TrainState, history list)."""
    generator = torch.Generator(device=lm.device).manual_seed(cfg.seed)
    mesh, sharding = current_mesh(), None
    if mesh is None:
        state = init_state(lm, optimizer, generator)
    else:
        rules = current_rules()
        if rules is None:
            raise ValueError("a mesh needs its logical_axis_rules bound "
                             "(launch.shardings.activation_rules)")
        lm.requires_grad_(True)
        state, sharding = sharded.shard_state(lm, optimizer, mesh, rules,
                                              generator)
    step_fn = make_train_step(lm, optimizer, lr_schedule, remat=cfg.remat,
                              clip_norm=cfg.clip_norm,
                              microbatches=cfg.microbatches,
                              sharding=sharding)
    start = 0
    ckpt = None

    def save(step, metadata):
        if mesh is None:
            ckpt.save_async(step, state, metadata=metadata)
        else:
            sharded.save(cfg.ckpt_dir, step, state, metadata, cfg.keep_last)

    if cfg.ckpt_dir:
        ckpt = Checkpointer(cfg.ckpt_dir, keep_last=cfg.keep_last)
        if latest_step(cfg.ckpt_dir) is not None:
            if mesh is None:
                restored_step, restored, meta = restore(cfg.ckpt_dir, state)
                state = _load_into(state, restored)
            else:
                restored_step, state, meta = sharded.restore(cfg.ckpt_dir,
                                                             state)
            start = int(restored_step)

    stop = {"now": False}

    def _handler(signum, frame):
        stop["now"] = True

    old_term = signal.signal(signal.SIGTERM, _handler)
    old_int = signal.signal(signal.SIGINT, _handler)

    try:
        for step in range(start, cfg.steps):
            batch_np, stats = pipeline.batch(step)
            batch = {k: torch.as_tensor(v, device=lm.device)
                     for k, v in batch_np.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = metrics["loss"].item()   # waits on the device
            dt = time.perf_counter() - t0
            if monitor is not None:
                # single-host container: every shard reports this host's time
                monitor.update(np.full(monitor.n_hosts, dt))
            row = {"step": step, "dt": dt,
                   **{k: float(v) for k, v in metrics.items()
                      if v.dim() == 0}}
            row["loss"] = loss
            cfg.history.append(row)
            if cfg.metrics_hook and step % cfg.log_every == 0:
                cfg.metrics_hook(step, row)
            if ckpt and (step + 1) % cfg.ckpt_every == 0:
                save(step + 1, {"loss": loss})
            if stop["now"]:
                break
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        if ckpt:
            save(int(state.opt.step), {"final": True})
            ckpt.wait()
            if mesh is not None:    # the files are whole for every rank
                dist.barrier()
    return state, cfg.history
