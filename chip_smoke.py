#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   — compile every kernel in src/repro_torch/kernels/csrc (one nvcc
             per source, all at once; five libraries) into
             build/repro_torch_kernels.
2. kernels — each CUDA kernel against its plain PyTorch version on the card,
             at the main path's shapes and at edge shapes; times of the
             kernel, the plain version and the library yardstick. The FIFO
             dispatch prefix's two full-shape calls (the slot wave and the
             per-slot totals) are also held bit for bit against the ordered
             loop on two rows each, and timed each with its bound; started
             from random queues (the engine's queue update) it is the
             ordered loop from them, bit for bit. The scan equals its plain
             version on the CPU (np.cumsum(x) - x) bit for bit. The MoE
             dispatch positions over all k levels (one launch) equal the
             plain version exactly at granite's prefill and decode, with
             overflowing levels, E = 1, 300 and 5000. Every
             bfloat16 flash case must run the tensor-core kernel (its own
             launch counter), every float32 one the FMA kernel; a bfloat16
             case passes when each output row lies within 1e-2 of the plain
             version's in relative L2 norm and each element within 3e-2
             (rtol and atol), a float32 one within 2e-5. The flash kernels'
             own tile rule (run on the host) must list the tiles of
             ``flash_attention.tile_plan`` over a grid of shapes. The flash
             times include the index form and the float32 kernel at the
             serve shape, beside scaled_dot_product_attention's.
3. sweep   — the main path: ``repro_torch.lab.sweep`` over a 12,500-node
             cluster (the size of Google clusterdata-2011-2's cell) at 60%
             offered Poisson load, PSTS with fifo_dispatch, 128 seeds. The
             launch counters are zeroed just before and read just after;
             two sampled seeds are held against the numpy ``simulate_scalar``
             oracle at rtol 1e-6, and the engine is rerun on the same
             tensors and must repeat every metric bit for bit; one more run
             under torch.profiler gives device time by kernel. It runs
             before phase 2, whose checks take the engine inputs the sweep
             lowered (the host lowers the 128 seeds once). Every phase's
             seconds, and the script's so far, go to stdout and stderr.
4. small   — a small faulted run twice on the card: bit-identical, and equal
             to ``simulate_scalar`` per seed at rtol 1e-6.
5. serve   — the second path: granite-moe-1b-a400m at full width (24
             layers, bf16 compute, f32 params, bf16 KV cache, weights from
             ``LM.init`` with a CUDA generator seeded 0) served through
             ``repro_torch.launch.serve.serve``: 2 replicas on one
             ReplicaScheduler, 8 slots each, max_len 4096, 32 requests with
             prompt lengths uniform in 256..2048, 16 new tokens each, greedy.
             The launch counters are zeroed just before and read just after
             and must equal 24 flash launches per prefill call, every one on
             the tensor cores, and 24 dispatch-positions launches (one per
             MoE layer, all 8 priority levels) per prefill call and decode
             step;
             a second run must repeat every token; one more short run under
             torch.profiler gives device time by kernel, flash's included.
6. serve-vs-plain — the same config with 2 layers in float32, the same
             weights on the card and on the CPU (which runs the plain
             versions): 4 right-padded prompts prefilled on each (the CPU
             compares its second prefill: see the warm-up's comment in
             ``phase_serve_vs_plain``); last-token
             logits within 1e-4 x max|logit| and every layer's routing equal
             (see ``phase_serve_vs_plain``).
7. kernels (mamba) — the selective-scan kernel against its plain version on
             the card at falcon-mamba-7b's prefill shape (4, 2048, 16, 8192)
             and at edges (S = 1, S = 130, di = 36 and 256, bf16 inputs,
             padded rows), rtol and atol 1e-4; times.
8. falcon-serve — the third path: falcon-mamba-7b at full width and depth
             (64 Mamba layers, d_model 4096, f32 params, bf16 compute and SSM
             state, weights from ``LM.init`` with a CUDA generator seeded 0)
             served through ``repro_torch.launch.serve.serve``: 2 replicas, 4
             slots each, max_len 4096, 16 requests with prompt lengths
             uniform in 256..2048, 8 new tokens each, greedy. Launch
             counters zeroed just before and read just after: 64 scan
             launches per prefill call, none per decode step, none of the
             other kernels; a second run repeats every token; peak memory
             under 80 GB; a short profiled run.
9. falcon-vs-plain — falcon-mamba-7b cut to 2 layers in float32, the same
             weights on the card and the CPU: 4 right-padded prompts of
             100-512 tokens prefilled, then 4 decode steps; last-token logits
             within 1e-4 x max|logit| at each step, the SSM state and conv
             tail after prefill within 1e-4 x max.
10. hybrid-vs-plain — jamba-v0.1-52b's smoke config (8 sub-layers: 7 Mamba,
             1 attention, 4 MoE) in float32 on the card and the CPU: the
             same logits check, every MoE sub-layer's routing equal, and the
             card's launch counts show all three LM kernels (flash on its
             float32 kernel).
11. events — the host event engine beside the batched one on the card: a
             1,024-node cluster (powers 1..10) at 60% offered Poisson load,
             work mean 6, horizon 12.5, PSTS (floor 0.1, trigger period
             1), about 7,200 tasks a seed. ``lab.sweep`` with backend "auto"
             must send seeds 0-1 to ``events`` and seeds 0-7 to ``batched``
             (on the card); for seeds 0 and 1 both backends realize the same
             arrivals, and on events every task completes, with migrations
             and trigger fires. Seed 0 rerun on events with tracing, probes
             and the metrics registry on gives a byte-identical
             ``Metrics.summary()`` (json.dumps) and an OpenMetrics scrape
             that parses back; ``legacy`` on seed 0 twice gives equal
             results with finite crossover, speedup and overhead. Seconds
             per events run, microseconds per task, and the events-vs-
             batched gaps in makespan and mean response are printed, not
             checked (the fluid timeline ends at the horizon).
12. traces, federations, DAGs — the seventh slice's paths:
    a. trace-12.5k, on the card: ``lab.sweep`` (backend "auto") of seeds
       0-7 over the bundled Google excerpt parsed with
       eviction_mode="end" and rate-scaled 966x (``TraceRef(scale=966)``,
       ~0.8 M tasks a seed in the first 200 s) on the 12,500-node cluster,
       PSTS with fifo_dispatch. It must run on ``batched``, flag the
       trace's priorities and eviction outcomes as ignored, launch the scan
       and dispatch kernels (counters zeroed just before, read just
       after); seeds 0 and 7 equal ``simulate_scalar`` at rtol 1e-6, and
       the engine rerun on the same tensors repeats every metric bit for
       bit. Host seconds (scaling and lowering) and engine seconds, peak
       memory and trigger fires per seed are printed.
    b. trace-replay-16, host: the whole excerpt with its constraints table,
       eviction_mode="requeue" and its machine_events companion on
       examples/trace_replay.py's 16-node, 4-class cluster, as psts/aware
       and as arrival_only/blind on ``events``: every task completes,
       evictions, failures, joins and resizes all happen, per-tier waits
       and counts are reported, and psts/aware's tier-0 mean wait is below
       arrival_only/blind's.
    c. federations: a link-free federation of 8 clusterdata-12.5k members
       (seeds 0-7) runs on ``federated`` as one fluid batch on the card
       (counters show the scan and dispatch kernels), its members equal a
       batched ``lab.sweep`` of the same 8 scenarios and its aggregate
       arrivals and completions their sums; then the geo-federation
       preset's shape at 4 x 256 nodes, horizon 25 (member 0 at 120%
       offered load, the others at 30%) on the host event model: every
       task completes, WAN migrations happen, the mean response beats the
       same members isolated, and a rerun is equal to the byte.
    d. dag-256, host: phase 11's scenario cut to 256 nodes with a random
       DAG: ``batched`` refuses it with the JAX package's reason, and on
       ``events`` every task completes and the work census closes.
13. the lab CLI and the scheduler service — the eighth slice's paths,
    driven in-process through ``repro_torch.lab.cli.main`` (the entry point
    of ``python -m repro_torch.lab``) so the launch counters can be read:
    a. ``sweep`` of phase 3's scenario file over seeds 0-7, no
       ``--device``: it must run on ``batched`` on the card, launch the
       scan and the dispatch prefix 201 times each (counters zeroed just
       before, read just after), and write metrics equal to the bit to a
       direct ``lab.sweep`` of the same seeds. The CLI's wall time and its
       engine call (the batched backend's ``simulate_batch``, wrapped) are
       printed.
    b. ``run --backend online`` on phase 11's scenario (seed 0): the
       scheduler service streams the tasks in one arrival batch per
       micro-step; the metrics it writes equal phase 11's events run byte
       for byte. Seconds per run, us per task, decisions.
    c. ``serve`` on phase 11's scenario cut to horizon 10, plus a JSONL feed
       of 100 tasks, with ``--decisions-out``, ``--metrics-out``,
       ``--metrics-every 5`` and ``--metrics-port 0``: every task
       completes (the scenario's and the feed's), every decision line
       parses and their count is the sum of the counts in ``--out``, the
       metrics stream's completion counter is monotone and ends at the
       completed count, and a scrape of the live endpoint parses.
    d. ``template --preset geo-federation`` and ``planet-federation``, then
       ``run`` on each: on ``federated``, every task completes, and WAN
       migrations happen.
14. training — the ninth slice's path:
    a. the backward kernels against their plain versions on the card:
       ``flash_attention_bwd`` (through ``ops.flash_attention``'s autograd,
       one call a check; every bf16 call on the tensor-core kernels, counted
       in ``flash_attention_bwd_tc``, every float32 one on the FMA kernels)
       at granite-moe-1b-a400m's training shape (B 4, H 16, KV 8, S 2048,
       hd 64, bf16, causal: each gradient row within 3e-2 in relative L2
       norm over the rows whose norm is at least 1e-3 of the largest, each
       element within 6e-2, rtol and atol), at bf16 edges (S 1 and 65, hd
       32, 128 and 256, window, soft-cap, non-causal) and float32 ones
       (window 16, soft-cap 30, hd 128 and 256: 1e-4 x max); the kernels'
       own tiles and walks (their rule, run on the host) against
       ``bwd_tiles``, ``tile_plan``'s index form and ``bwd_key_plan``; a
       repeat equal to the bit; ``mamba_scan_bwd`` at (1, 2048, 16, 8192)
       and edges (1e-5 x max). Times beside the plain versions, the bounds
       and SDPA's backward, and the float32 kernels at olmo-1b's (1, 4, 4,
       200, 128).
    b. granite-train: granite-moe-1b-a400m at full width and depth (24
       layers, f32 params and moments, bf16 compute, weights from a CUDA
       generator seeded 0) trained 8 steps through ``repro_torch.train.
       train`` with ``launch.train``'s AdamW and warmup_cosine, remat on, a
       ``Pipeline`` of 2 shards x 2 rows x 2048 tokens. The counters are
       zeroed just before each step and read just after: 48 flash forwards
       (24 and 24 remat recomputes, all on the tensor cores), 24 flash
       backwards (all on the tensor cores), 48 dispatch-positions launches
       and none of the others.
       Losses and gradient norms finite, the mean of the last 3 losses below
       the first; step time, tokens/s, peak memory, and one more step under
       torch.profiler for the device's busy share and the time of each
       kernel, the backward's dQ and dK/dV kernels apart.
    c. falcon-train: falcon-mamba-7b at full width cut to 2 layers, 4 steps
       on 1 x 2048 tokens: finite losses, 4 scan forwards and 2 scan
       backwards a step.
    d. train-vs-plain: float32 gradients on the card against the CPU's from
       the same weights: olmo-1b at full width (d 2048, hd 128) with 2
       layers on 2 x 512 tokens, then granite's 2 layers one sequence at a
       time, compared when both devices route it alike (a top-k decided by
       a near tie is reported and left out): the loss within 1e-5
       relative, each gradient within 1e-3 x its leaf's max|g|.
    e. restart: ``repro_torch.launch.train.main`` in-process, granite at
       full width cut to 2 layers, 4 steps with checkpoints every 2 (files
       under build/chip_smoke_train/); again after the step-4 checkpoint is
       removed, which resumes at step 2: the resumed losses must equal the
       uninterrupted run's bit for bit (within 1e-6 relative, reported,
       if an op around the kernels were not deterministic).
15. the distributed layer — the eleventh slice's paths:
    a. in a child process (``chip_smoke.py --mesh-child OUT SMI``, which
       writes its result to OUT as JSON): an NCCL world
       of 1 rank on the card (address tcp://localhost at a free port) and
       the (1, 1) ("data", "model") mesh of ``launch.mesh.elastic_mesh(1,
       model_parallel=1)``; ``core.axis_exclusive_scan`` over its size-1
       axis returns (0, x); then granite-moe-1b-a400m at full width and
       depth trained 3 steps through ``repro_torch.train.train`` as
       ``launch.train`` calls it, without a mesh and then under
       ``set_mesh`` and the mesh's activation rules (DTensor state, the
       weights gathered at use, the sharded step): the losses and every
       parameter equal bit for bit, and both runs launch a step what 14b
       does (the gathers launch none of the kernels). Step time, tokens/s
       and peak memory of both runs.
    b. ``python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m
       --shape train_4k --mesh single`` (a fake world of 256 ranks, the LM
       on meta; run on the host from phase 2 on, a CPU-only child) into
       build/chip_smoke_dryrun/, then ``python -m
       repro_torch.launch.summarize`` over it: the record parses and its
       state bytes a rank equal the sharding plan's arithmetic for the
       16 x 16 mesh (``plan_state_bytes``).
    c. the split over ``model``: two child processes
       (``chip_smoke.py --tp-child RANK PORT OUT SMI LOSSES``), one gloo
       rank each (NCCL refuses two ranks on one device; tcp://localhost at
       a free port), share the card on the (1, 2) ("data", "model") mesh:
       (a) granite-moe-1b-a400m at full width cut to 2 layers, float32
       (8 of 16 query heads, 4 of 8 KV heads, 16 of 32 experts and half
       the vocabulary a rank), and (b) falcon-mamba-7b likewise (4,096 of
       8,192 channels a rank), each one loss and its gradients on 2 x 512
       tokens against the unsharded LM's on the CPU (the plain versions
       of the kernels) from the same weights (phase 14d's bounds and
       near-tie rule; the gradients gathered from the ranks); (c) granite
       at full width and depth in bf16 trained 3 steps as 15a trains it,
       its LM drawn on meta: each step's loss within 2e-4 relative and
       its gradient norm within 3e-2 relative of 15a's (1, 1) run's,
       14b's launches
       a step on each rank at the local shapes (printed), step time,
       tokens/s and each rank's peak memory, and one more loss and its
       gradients under torch.profiler (gloo's host time, the device's busy
       time). The ranks' logs stay under build/chip_smoke_tp/ when the
       phase fails.
16. prefill and decode split over ``model``: granite-moe-1b-a400m at full
    width cut to 6 layers in bf16 served unsharded on the card (8 of
    granite-serve's prompts into caches of 4,096 positions, 32 greedy
    decode steps: its tokens, logits and MoE routing the reference), then
    two child processes (``chip_smoke.py --split-child RANK PORT OUT SMI
    REF``), one gloo rank each, share the card on the (1, 2) ("data",
    "model") mesh, each rank computing its heads, ff columns, experts,
    channels and vocabulary columns from its block of the cache (its half
    of the KV sequence, its SSM channels): (a) granite and falcon-mamba-7b
    at full width cut to 2 layers in float32 (the KV cache too), prompts
    of 137, 503, 712 and 900 tokens into caches of 1,024 (rank 1's block
    past two of them, one crossing the edge in decode), 10 decode steps
    fed the unsharded LM's greedy tokens on the CPU (the plain versions):
    every call's logits within 1e-4 x max|logit|, the greedy tokens equal,
    the cache gathered from the ranks within 1e-4 x its max on the rows
    written, the launches counted; (b) granite in bf16 fed the reference's
    tokens: the logits' distance, the greedy agreement and the top-k
    choices that turned, reported; on the reference's routing replayed,
    every call's logits within 5e-2 x max|logit| of the reference's; a
    flash forward (on the tensor cores) and a positions launch a layer a
    prefill, a positions launch a layer a decode step; prefill tokens/s,
    decode ms a step and peak memory a rank beside the unsharded run's,
    and gloo's host time in a profiled decode step. The ranks' logs stay under
    build/chip_smoke_split/ when the phase fails.
17. expert parallelism over ``expert``: two child processes
    (``chip_smoke.py --ep-child RANK PORT OUT SMI LOSSES``), one gloo rank
    each, share the card on the (2, 1, 1) ("expert", "data", "model")
    mesh, each rank holding and running 16 of granite's 32 experts, the
    slot tensors moved by all-to-alls: (a) ``models.distributed.
    all_to_all`` on CUDA tensors, float32 and bf16, at a decode step's and
    a train step's slot tensor: forward and backward equal to the blocks
    sent, bit for bit, and timed; (b) granite-moe-1b-a400m at full width
    cut to 2 layers in float32: one loss and its gradients on 2 x 512
    tokens, a row a rank, against the unsharded LM's on the CPU (phase
    14d's bounds; its collectives recorded: six all-to-alls over
    ``expert`` a layer, no all-gather there), and a prefill of 2 prompts,
    a prompt a rank, and 8 decode steps (phase 6's bound on every call's
    logits, the greedy tokens equal); (c) granite at full width and depth
    in bf16, 14b's data, half a step's rows a rank, 3 steps on 15a's
    routing replayed (recorded by its mesh child): each step's loss and
    gradient norm within 15c(c)'s bounds of 15a's, 14b's launches a step
    a rank, step time, tokens/s, peak and a profiled loss and gradients
    beside 15c(c)'s; the routing turns that its own top-k would have made
    are counted; (d) ``core.axis_exclusive_scan`` over ``expert`` on CUDA
    float64 tensors of 64 B and 8 MiB: rank 0's exclusive sum zero, rank
    1's the ladder's (x1 + x0) - x1 and the total x0 + x1, bit for bit,
    and timed beside ``core.GpuCostModel``'s link term for the ladder on
    the NDR link. The dry run of granite's train_4k cell cut to 2 layers
    on ``make_production_mesh(ep=4)`` (run on the host from phase 2 on):
    its state bytes the plan's, twelve all-to-alls over ``expert`` of the
    slot tensor's bytes, no all-gather there. The ranks' logs stay under
    build/chip_smoke_ep/ when the phase fails.

The line before the last is the card's name and power limit from
nvidia-smi, the one before it the kernels' JSON record; the last line is the
JSON result. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import lab  # noqa: E402
from repro_torch import obs as obs_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import GpuCostModel  # noqa: E402
from repro_torch.data import DocStream, Pipeline  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_kernel  # noqa: E402
from repro_torch.lab.backends import (  # noqa: E402
    assemble_events_result,
    build_events_runtime,
)
from repro_torch.lab import backends as lab_backends  # noqa: E402
from repro_torch.lab import cli as lab_cli  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.common import dtype_of  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.obs import parse_openmetrics  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.sched import moe_dispatch  # noqa: E402
from repro_torch.sched.straggler import StragglerMonitor  # noqa: E402
from repro_torch.serve import Engine, GenRequest  # noqa: E402
from repro_torch.train import LoopConfig, make_train_step, train  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    VectorConfig,
    batch_slots,
    make_workload,
    simulate_batch,
    simulate_scalar,
    to_tensors,
)
from repro_torch.runtime.vector_backend import _simulate_batch_torch  # noqa: E402

N_NODES = 12_500
SEEDS = 128
RATE = 6880.0          # 60% of sum(powers) = 68,800 / work_mean 6
SAMPLED_SEEDS = (0, 77)
FIELDS = ("mean_response", "p99_response", "makespan", "trigger_fires",
          "moved_units", "completed")

# the serving path: granite-moe-1b-a400m at full width
ARCH = "granite-moe-1b-a400m"
SERVE_REQUESTS = 32
SERVE_REPLICAS = 2
SERVE_SLOTS = 8
SERVE_MAX_LEN = 4096
SERVE_NEW = 16          # was 64: cut to keep the script within its time limit
PROMPT_LO, PROMPT_HI = 256, 2048
# the third path: falcon-mamba-7b at full width
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "jamba-v0.1-52b"
SSM_REQUESTS = 16
SSM_SLOTS = 4
SSM_NEW = 8             # was 32: cut to keep the script within its time limit
SSM_DECODE_STEPS = 4    # falcon-vs-plain
SCAN_TOL = 1e-4         # the JAX package's mamba_scan tolerance
MEMORY_LIMIT = 80e9
BF16_TOL = 3e-2         # the JAX package's own kernel tolerances
F32_TOL = 2e-5
# bfloat16 flash, per output row: ||got - want|| / ||want|| over hd (bf16
# rounding of P and of the output gives ~3e-3; a tile dropped or a key
# leaked past a mask edge, 0.1 or more at these shapes)
BF16_ROW_TOL = 1e-2
LOGIT_TOL = 1e-4        # x max|logit|, card vs CPU (phase 6)
# the event engine (phase 11): the sweep cell's shape at the largest cluster
# the per-task host engine covers within the time limit
EV_NODES = 1024
EV_HORIZON = 12.5       # was 50: cut to keep the script within its time limit
EV_LOAD = 0.6
EV_WORK_MEAN = 6.0
EV_SMALL_SEEDS = 2      # below BATCH_THRESHOLD: auto picks events
EV_BATCH_SEEDS = 8      # at BATCH_THRESHOLD: auto picks batched
# phase 12: the bundled Google excerpt (10,000 tasks over 1,950 s)
TRACE_DATA = Path(__file__).resolve().parent / "benchmarks" / "data"
TRACE_FILE = TRACE_DATA / "google_excerpt_10k.csv.gz"
TRACE_CONSTRAINTS = TRACE_DATA / "google_excerpt_10k_constraints.csv.gz"
TRACE_MACHINES = TRACE_DATA / "google_excerpt_10k_machine_events.csv.gz"
# 966x the excerpt's 42.72 work units/s offers 60% of the 12,500-node
# cluster's 68,800 over the whole trace
TRACE_SCALE = 966.0
TRACE_HORIZON = 200.0   # was 400: cut to keep the script within its time limit
TRACE_SEEDS = 8         # was 16: cut to keep the script within its time limit
TRACE_SAMPLED = (0, 7)
TRACE_IGNORED = ("workload trace priorities",
                 "workload trace eviction outcomes (ends_evicted)")
# examples/trace_replay.py's cluster: 4 machine classes x 4 nodes
REPLAY_POWERS = (1.0,) * 4 + (1.25,) * 4 + (1.75,) * 4 + (2.0,) * 4
REPLAY_ATTRS = {"machine_class": (0.0,) * 4 + (1.0,) * 4 + (2.0,) * 4
                + (3.0,) * 4}
FED_MEMBERS = 8
GEO_NODES = 256
GEO_HORIZON = 25.0      # was 50: cut to keep the script within its time limit
GEO_LOADS = (1.2, 0.3, 0.3, 0.3)
DAG_NODES = 256
CLI_SEEDS = 8           # the batch threshold: the CLI sweep goes to batched
SERVE_HORIZON = 10.0    # 13c: phase 11's scenario cut to this horizon
SERVE_FEED = 100        # 13c: tasks fed over JSONL on top of it
# 13: files the CLI reads and writes (build/ is not part of the repo)
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
# the JAX package's batched refusal of a DAG workload, word for word
DAG_REASON = ("workload declares a task-dependency DAG; the fluid model has "
              "no per-task identity to gate releases on parent completions "
              "— run on the events backend")

# NVIDIA H100 SXM data sheet: HBM3 rate, non-tensor FP64 rate (the scan and
# prefix kernels do float64 adds outside the tensor cores), dense bf16
# tensor-core rate (what bounds attention's products)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12  # non-tensor float32 (the scan's fma)


def log(*args):
    print(*args, flush=True)


T_START = time.perf_counter()   # main() sets it after its first checks


def mark(phase: str, since: float) -> float:
    """Log the seconds since ``since`` and since the script's start for
    ``phase``, on stdout and on stderr (where a run stopped at its time
    limit shows how far it got); returns the time now."""
    now = time.perf_counter()
    line = (f"[phase {phase}] {now - since:.1f}s ({now - T_START:.1f}s "
            f"since the start)")
    log(line)
    print(line, file=sys.stderr, flush=True)
    return now


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of ``fn`` per call: the kernels it launches, summed by
    torch.profiler over ``reps`` calls after a warm-up. For a launch shorter
    than its host-side issue time, where back-to-back CUDA events measure
    the host, not the card."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(evt, "self_device_time_total", 0.0)
                   for evt in prof.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP64_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_err(x):
    """Max |kernel - plain| over the row's magnitude; the kernel's launch
    here is a comparison launch, not a main-path one."""
    got, want = ops.prefix_scan(x), ref.prefix_scan_ref(x)
    torch.cuda.synchronize()
    if x.numel() == 0:
        return 0.0, 0.0
    scale = x.abs().sum(-1, keepdim=True).clamp_min(1e-300)
    return ((got - want).abs() / scale).max().item(), \
        (got - want).abs().max().item()


def dispatch_err(idx, w, e):
    gp, gf = ops.dispatch_work_prefix(idx, w, e)
    wp, wf = ref.dispatch_work_prefix_ref(idx, w, e)
    torch.cuda.synchronize()
    rel = max(((gp - wp).abs() / wp.abs().clamp_min(1e-300)).max().item()
              if gp.numel() else 0.0,
              ((gf - wf).abs() / wf.abs().clamp_min(1e-300)).max().item())
    absd = max((gp - wp).abs().max().item() if gp.numel() else 0.0,
               (gf - wf).abs().max().item())
    return rel, absd


def ordered_loop(idx_row, w_row, e, init=None):
    """The FIFO prefix of one row as simulate_scalar sums it: acc[d] += w in
    token order, in Python floats (IEEE float64), from ``init`` (a list)
    or zeros. Returns (prefix, fill)."""
    acc = [0.0] * e if init is None else list(init)
    out = [0.0] * len(idx_row)
    for j, (d, x) in enumerate(zip(idx_row, w_row)):
        if 0 <= d < e:
            out[j] = acc[d]
            acc[d] += x
    return (torch.tensor(out, dtype=torch.float64),
            torch.tensor(acc, dtype=torch.float64))


def scenario() -> lab.Scenario:
    return lab.Scenario(
        cluster=lab.ClusterSpec(n_nodes=N_NODES, power_low=1, power_high=10,
                                power_seed=0),
        workload=lab.WorkloadSpec(process="poisson", horizon=200.0,
                                  work_mean=6.0, params={"rate": RATE}),
        policy=lab.PolicySpec("psts", params={"floor": 0.1}))


def phase_build():
    t0 = time.perf_counter()
    report = _build.build()
    log(f"[build] {len(report)} kernels in {time.perf_counter() - t0:.2f}s "
        f"(parallel nvcc)")
    for name, r in report.items():
        info, kernel = [], "?"
        for ln in r["ptxas"].splitlines():
            if "entry function" in ln:
                kernel = ln.split("'")[1]
            elif "Used" in ln or "spill" in ln:
                info.append(f"{kernel}: {ln.strip()}")
        log(f"[build]   {name}: {r['seconds']:.2f}s {' | '.join(info)}")


def phase_kernels(dev, slot, works, cfg):
    """Every kernel against its plain version; returns the timings at the
    main path's shapes."""
    B, M = works.shape
    T, n = cfg.n_slots, cfg.n_nodes
    g = torch.Generator().manual_seed(0)
    valid = slot < T

    # -- prefix scan: (B, M) task works, (B, n) normalized powers, edges
    gam = torch.rand(B, n, dtype=torch.float64, generator=g).to(dev)
    gam = gam / gam.sum(-1, keepdim=True)
    worst = 0.0
    for label, x in [("works (B, M)", works), ("lam (B, n)", gam)] + [
            (f"edge {r}x{c}",
             (torch.rand(r, c, dtype=torch.float64, generator=g) * 11).to(dev))
            for r, c in [(1, 1), (3, 7), (5, 2049), (7, 130), (1, 100_003),
                         (4, 0)]]:
        rel, absd = scan_err(x)
        log(f"[kernels] prefix_scan {label} {tuple(x.shape)}: "
            f"max|err|/row_total={rel:.3e} max|err|={absd:.3e}")
        if not rel <= 1e-12:
            fail(f"prefix_scan {label}: error {rel} > 1e-12 x row total")
        if label.startswith("works"):
            worst = absd
    # bit for bit the plain version on the CPU (np.cumsum(x) - x, the
    # oracle's S and lam): the engine's owner choice reads these bits
    for label, x in [("works rows 0 and B-1", works[[0, B - 1]]),
                     ("lam (B, n)", gam)] + [
            (f"edge {r}x{c}", torch.rand(r, c, dtype=torch.float64,
                                         generator=g).to(dev) * 11)
            for r, c in [(1, 1), (3, 7), (5, 2049), (1, 100_003)]]:
        if not torch.equal(ops.prefix_scan(x.contiguous()).cpu(),
                           ref.prefix_scan_ref(x.cpu())):
            fail(f"prefix_scan {label}: not bit for bit the sequential "
                 f"scan")
    log("[kernels] prefix_scan bit for bit the plain version on the CPU "
        "(works rows, lam, edges)")
    scan_ms = time_ms(lambda: ops.prefix_scan(works), 10)
    scan_plain = time_ms(lambda: ref.prefix_scan_ref(works), 10)
    scan_lib = time_ms(lambda: torch.cumsum(works, dim=-1) - works, 10)
    lam_ms = time_ms(lambda: ops.prefix_scan(gam), 50)
    lam_plain = time_ms(lambda: ref.prefix_scan_ref(gam), 50)
    log(f"[kernels] prefix_scan (B, n) lam shape: {lam_ms:.4f} ms, plain "
        f"{lam_plain:.4f} ms")
    scan_bound, scan_by = bound_ms(2 * 8 * B * M, B * M)
    scan = dict(name="prefix_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/prefix_scan.cu",
                replaces="src/repro/kernels/prefix_scan.py:42",
                max_abs_err=worst, ms=scan_ms, plain_ms=scan_plain,
                bound_ms=scan_bound, bound_by=scan_by, library_ms=scan_lib,
                shape=[B, M])

    # -- dispatch: one slot's wave (E = n nodes), the per-slot totals
    # (E = T slots), and edges
    t_mid = T // 2
    mask = slot == t_mid
    owners = torch.randint(0, n, (B, M), generator=g,
                           dtype=torch.int32).to(dev)
    wave_idx = torch.where(mask, owners, -1).to(torch.int32)
    wave_w = torch.where(mask, works, 0.0)
    tot_idx = torch.where(valid, slot, -1).to(torch.int32)
    worst = 0.0
    cases = [("slot wave (B, M), E=n", wave_idx, wave_w, n),
             ("slot totals (B, M), E=T", tot_idx, works, T)]
    for e in (1, 8, 128, 12_500, 40_000):
        idx = torch.randint(0, e, (4, 20_000), generator=g, dtype=torch.int32)
        keep = torch.rand(4, 20_000, generator=g) < 0.5
        idx = torch.where(keep, idx, -1).to(torch.int32).to(dev)
        w = (torch.rand(4, 20_000, dtype=torch.float64, generator=g)
             * 11).to(dev)
        cases.append((f"edge E={e}", idx, w, e))
    cases.append(("edge all -1", torch.full((3, 5000), -1, dtype=torch.int32,
                                            device=dev),
                  torch.ones(3, 5000, dtype=torch.float64, device=dev), 8))
    for label, idx, w, e in cases:
        rel, absd = dispatch_err(idx, w, e)
        log(f"[kernels] dispatch_work_prefix {label} {tuple(idx.shape)}: "
            f"max rel err={rel:.3e} max|err|={absd:.3e}")
        if not rel <= 1e-12:
            fail(f"dispatch_work_prefix {label}: rel error {rel} > 1e-12")
        if label.startswith("slot wave"):
            worst = absd
    # the two full-shape calls bit for bit the ordered loop, on sampled rows
    for label, idx, w, e in cases[:2]:
        prefix, fill = ops.dispatch_work_prefix(idx, w, e)
        for row in (0, B - 1):
            t0 = time.perf_counter()
            want_p, want_f = ordered_loop(idx[row].tolist(), w[row].tolist(),
                                          e)
            if not (torch.equal(prefix[row].cpu(), want_p)
                    and torch.equal(fill[row].cpu(), want_f)):
                fail(f"dispatch_work_prefix {label} row {row}: not bit for "
                     f"bit the ordered loop")
            log(f"[kernels] dispatch_work_prefix {label} row {row}: prefix "
                f"and fill bit for bit the ordered loop "
                f"({time.perf_counter() - t0:.1f}s)")
    # the slot wave started from queues (the engine's np.add.at order)
    init = (torch.rand(B, n, dtype=torch.float64, generator=g) * 500).to(dev)
    prefix, fill = ops.dispatch_work_prefix(wave_idx, wave_w, n, init=init)
    for row in (0, B - 1):
        want_p, want_f = ordered_loop(wave_idx[row].tolist(),
                                      wave_w[row].tolist(), n,
                                      init[row].tolist())
        if not (torch.equal(prefix[row].cpu(), want_p)
                and torch.equal(fill[row].cpu(), want_f)):
            fail(f"dispatch_work_prefix slot wave from init row {row}: not "
                 f"bit for bit the ordered loop")
    log("[kernels] dispatch_work_prefix slot wave from init (the queue "
        "update): rows 0 and B-1 bit for bit the ordered loop")
    # each full-shape call timed, beside its bound and its plain version:
    # 4 B read per token, 8 B written per prefix, 8 B read per valid weight,
    # 8 B written per fill cell; one float64 add per valid token
    timed = {}
    for label, idx, w, e in cases[:2]:
        n_valid = int(((idx >= 0) & (idx < e)).sum())
        bound, by = bound_ms(B * M * (4 + 8) + n_valid * 8 + B * e * 8,
                             n_valid)
        timed[label] = dict(
            ms=time_ms(lambda: ops.dispatch_work_prefix(idx, w, e), 10),
            plain_ms=time_ms(lambda: ref.dispatch_work_prefix_ref(idx, w, e),
                             2),
            bound_ms=bound, bound_by=by, valid=n_valid)
        log(f"[kernels] dispatch_work_prefix {label} at {[B, M]}, E={e}, "
            f"{n_valid} valid tokens: {timed[label]['ms']:.4f} ms, plain "
            f"{timed[label]['plain_ms']:.4f} ms, library None, bound "
            f"{bound:.4f} ms ({by}), {100 * bound / timed[label]['ms']:.1f}% "
            f"of it")
    wave, tot = timed[cases[0][0]], timed[cases[1][0]]
    disp = dict(name="dispatch_work_prefix", route="cuda",
                source="src/repro_torch/kernels/csrc/psts_dispatch.cu",
                replaces="src/repro/kernels/psts_dispatch.py:98",
                max_abs_err=worst, ms=wave["ms"], plain_ms=wave["plain_ms"],
                bound_ms=wave["bound_ms"], bound_by=wave["bound_by"],
                library_ms=None, shape=[B, M],
                totals_ms=tot["ms"], totals_plain_ms=tot["plain_ms"],
                totals_bound_ms=tot["bound_ms"])
    log(f"[kernels] {scan['name']} at {scan['shape']}: {scan['ms']:.4f} ms, "
        f"plain {scan['plain_ms']:.4f} ms, library {scan['library_ms']}, "
        f"bound {scan['bound_ms']:.4f} ms ({scan['bound_by']})")
    return [scan, disp]


def phase_sweep(base):
    """The main path, driven through the lab entry point. The engine's
    inputs, as the sweep lowered them, are kept (by wrapping the batched
    backend's ``simulate_batch``) for phase 2's kernel checks and the
    rerun, so that the host lowers the 128 seeds once. Returns (results,
    launches, (slot, works, powers, cfg, power_scale))."""
    calls = []
    engine = lab_backends.simulate_batch

    def kept(slot, works, powers, cfg, power_scale=None, *, device=None):
        calls.append((slot, works, powers, cfg, power_scale))
        return engine(slot, works, powers, cfg, power_scale=power_scale,
                      device=device)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    lab_backends.simulate_batch = kept
    try:
        t0 = time.perf_counter()
        results = lab.sweep(base=base, grid={"seed": range(SEEDS)},
                            fifo_dispatch=True)
        wall = time.perf_counter() - t0
    finally:
        lab_backends.simulate_batch = engine
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if len(calls) != 1:
        fail(f"sweep: {len(calls)} engine calls, expected one batched call")
    slot, works, powers, cfg, scale = calls[0]
    log(f"[sweep] {SEEDS} seeds x {N_NODES} nodes x {cfg.n_slots} slots: "
        f"wall {wall:.2f}s (workload generation included), peak device "
        f"memory {peak / 2**30:.2f} GiB, launches {launches}; slot/works "
        f"{slot.shape}, sum(powers)={powers.sum():.0f}")
    if [r.backend for r in results] != ["batched"] * SEEDS:
        fail("the sweep did not auto-dispatch to the batched backend")
    # the serving and sweep paths launch no backward kernel
    want = {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "mamba_scan_bwd": 0,
            "prefix_scan": 1 + cfg.n_slots,
            "dispatch_work_prefix": 1 + cfg.n_slots,
            "dispatch_positions": 0, "flash_attention": 0,
            "flash_attention_tc": 0, "mamba_scan": 0}
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    tasks = sum(r["completed"] for r in results)
    for r in results:
        m = r.metrics
        if not (m["completed"] > 0 and all(
                math.isfinite(m[k]) for k in ("makespan", "mean_response",
                                              "p99_response",
                                              "moved_units"))):
            fail(f"non-finite or empty result: {m}")
    mean_resp = float(np.mean([r["mean_response"] for r in results]))
    log(f"[sweep] {tasks} tasks, mean response {mean_resp:.6f}, "
        f"trigger fires/seed {np.mean([r['trigger_fires'] for r in results])}")
    for s in SAMPLED_SEEDS:
        t0 = time.perf_counter()
        wl = base.workload.materialize(s)
        slot1, works1, _ = batch_slots([wl], cfg.dt, cfg.n_slots)
        sm = simulate_scalar(slot1[0], works1[0], powers, cfg,
                             power_scale=scale)
        got = results[s].metrics
        for k in FIELDS:
            if not np.isclose(got[k], sm[k], rtol=1e-6, atol=0.0):
                fail(f"seed {s} {k}: batched {got[k]!r} vs scalar {sm[k]!r}")
        log(f"[sweep] seed {s} matches simulate_scalar at rtol 1e-6 "
            f"({time.perf_counter() - t0:.1f}s): "
            + ", ".join(f"{k}={got[k]!r}/{sm[k]!r}" for k in FIELDS))
    return results, launches, calls[0]


def phase_repeat(results, tensors, cfg):
    """Rerun the engine on the sweep's tensors: every metric must repeat
    bit for bit (the determinism the trigger and owner branches need)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _simulate_batch_torch(*tensors, cfg)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    got = [v.cpu().numpy() for v in out[:6]]
    for k, v in zip(FIELDS, got):
        prev = np.array([r[k] for r in results], dtype=np.float64)
        if not np.array_equal(prev, v.astype(np.float64)):
            fail(f"full-width rerun differs in {k}")
    log(f"[repeat] full-width engine rerun bit-identical; engine time "
        f"{engine_s:.2f}s (tensors already on the card)")
    return engine_s


def device_time_table(fn, wall_s: float, tag: str, watch=()) -> None:
    """Run ``fn`` once under torch.profiler; log device time by kernel and
    its share of ``wall_s``, the same work's unprofiled wall time, and the
    kernels whose names hold a string of ``watch`` wherever they rank.
    Returns the device's busy share of ``wall_s`` (None without device
    time). Only the device is traced: the kernels' times are the same
    with the host's ops traced too, and reading those costs ~3x the time
    (the engine's 94,000 launches: 67 s against 21 s on an H100 host)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, evt.count, evt.key))
    total_us = sum(r[0] for r in rows)
    if total_us <= 0:
        log(f"[{tag}] torch.profiler recorded no device time")
        return None
    log(f"[{tag}] device kernel time {total_us / 1e6:.3f}s in "
        f"{sum(r[1] for r in rows)} kernel launches = "
        f"{100 * total_us / 1e6 / wall_s:.1f}% of the unprofiled time "
        f"{wall_s:.2f}s (the rest: device idle)")
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        log(f"[{tag}]   {100 * dev_us / total_us:5.1f}%  "
            f"{dev_us / 1e3:9.2f} ms  x{count:<5d} {key[:90]}")
    for name in watch:
        hits = [r for r in rows if name in r[2]]
        dev_us = sum(r[0] for r in hits)
        count = sum(r[1] for r in hits)
        log(f"[{tag}] {name}: {dev_us / 1e3:.4f} ms device time in {count} "
            f"launches ({dev_us / 1e3 / max(count, 1):.4f} ms each, "
            f"{100 * dev_us / total_us:.2f}% of the device time)")
    return total_us / 1e6 / wall_s


def phase_profile(tensors, cfg, engine_s):
    """Where the engine's device time goes: one more full-width run under
    torch.profiler, device time by kernel, and the busy share of the
    unprofiled engine time."""
    device_time_table(lambda: _simulate_batch_torch(*tensors, cfg), engine_s,
                      "profile", watch=("work_prefix",))


def phase_small(dev):
    powers = np.random.default_rng(1).integers(1, 11, size=64).astype(float)
    cfg = VectorConfig(n_nodes=64, n_slots=100, fifo_dispatch=True,
                       floor=0.1, probe=True)
    wls = [make_workload("bursty", horizon=100.0, seed=s, rate_lo=20.0,
                         rate_hi=120.0, work_mean=6.0) for s in range(16)]
    slot, works, _ = batch_slots(wls, 1.0, 100)
    scale = np.ones((100, 64))
    scale[30:60, 7] = 0.0
    scale[40:, 11] = 0.5
    a = simulate_batch(slot, works, powers, cfg, power_scale=scale,
                       device=dev)
    b = simulate_batch(slot, works, powers, cfg, power_scale=scale,
                       device=dev)
    for k in FIELDS + ("probe_queue", "probe_imbalance", "probe_fires"):
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            fail(f"small run not bit-identical in {k}")
    for i in range(16):
        sm = simulate_scalar(slot[i], works[i], powers, cfg,
                             power_scale=scale)
        for k in FIELDS:
            if not np.isclose(getattr(a, k)[i], sm[k], rtol=1e-6, atol=0.0):
                fail(f"small seed {i} {k}: {getattr(a, k)[i]!r} vs "
                     f"{sm[k]!r}")
    log(f"[small] 16 seeds x 64 nodes: two runs bit-identical, all seeds "
        f"match simulate_scalar; fires {a.trigger_fires.tolist()}")


# ---------------------------------------------------------------------------
# the serving path: flash attention and the expert-dispatch positions
# ---------------------------------------------------------------------------

def flash_check(label, b, h, kv, s, hd, dtype, g, dev, **kw):
    """The kernel against its plain version; returns max|err|, the worst
    row's relative error and the inputs. ``lengths`` in ``kw`` selects the
    length form. A bfloat16 call must launch the tensor-core kernel, a
    float32 one the FMA kernel."""
    q = torch.randn(b, h, s, hd, generator=g).to(dev, dtype)
    k = torch.randn(b, kv, s, hd, generator=g).to(dev, dtype)
    v = torch.randn(b, kv, s, hd, generator=g).to(dev, dtype)
    if "lengths" in kw:
        kw["lengths"] = torch.as_tensor(np.asarray(kw["lengths"]),
                                        dtype=torch.int32, device=dev)
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, **kw).float()
    after = ops.launch_counts()
    want = ref.flash_attention_ref(q, k, v, **kw).float()
    torch.cuda.synchronize()
    tc = after["flash_attention_tc"] - before["flash_attention_tc"]
    if (after["flash_attention"] - before["flash_attention"],
            tc) != (1, int(dtype == torch.bfloat16)):
        fail(f"flash_attention {label}: {tc} tensor-core launches for "
             f"{dtype}")
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err = (got - want).abs()
    row = ((got - want).norm(dim=-1)
           / want.norm(dim=-1).clamp_min(1e-30)).max().item()
    log(f"[kernels] flash_attention {label} {(b, h, kv, s, hd)} "
        f"{str(dtype)[6:]} ({'tensor cores' if tc else 'FMA'}): "
        f"max|err|={err.max().item():.3e}, worst row's relative L2 error "
        f"{row:.3e}")
    if not bool((err <= tol + tol * want.abs()).all()):
        fail(f"flash_attention {label}: error beyond {tol} (rtol and atol)")
    if dtype == torch.bfloat16 and not row <= BF16_ROW_TOL:
        fail(f"flash_attention {label}: a row's relative error {row:.3e} "
             f"exceeds {BF16_ROW_TOL}")
    return err.max().item(), row, (q, k, v, kw)


def check_tile_plan():
    """The kernels' own tile rule (``make_plan``, run on the host through
    the library) against ``flash_attention.tile_plan``, which the CPU tests
    hold against the plain version's mask: every query tile of a grid of
    lengths, windows and both masks, at the kernels' 64 x 64 tiles."""
    n = 0
    for s in (1, 63, 64, 65, 129, 300, 700, 2048):
        for length in sorted({1, 2, 63, 64, 65, 200, s // 2 or 1, s}):
            if length > s:
                continue
            for causal in (True, False):
                for window in (None, 1, 63, 64, 100, 300):
                    for q0 in range(0, s, 64):
                        case = (q0, 64, 64, s, length, causal, window)
                        if flash.cuda_tile_plan(*case) != \
                                flash.tile_plan(*case):
                            fail(f"flash tile plan differs at {case}: card "
                                 f"{flash.cuda_tile_plan(*case)}, rule "
                                 f"{flash.tile_plan(*case)}")
                        n += 1
    log(f"[kernels] flash_attention tile plan: the kernels' rule lists "
        f"tile_plan's tiles for all {n} query tiles of the grid")


def phase_kernels_lm(dev):
    """flash_attention and dispatch_positions against their plain versions
    at the serving path's shapes and at edges; times at the main path's
    shapes. Returns their kernel records (launches filled in later)."""
    g = torch.Generator().manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    # -- flash: granite's prefill (B 8, H 16, KV 8, S 2048, hd 64, bf16),
    # right-padded to the bucket as the serve phase's prompts are
    lengths = np.random.default_rng(1).integers(PROMPT_LO, PROMPT_HI + 1,
                                                size=8)
    check_tile_plan()
    worst, worst_row, (q, k, v, kw) = flash_check(
        "serve prefill, padded", 8, 16, 8, 2048, 64, bf16, g, dev,
        lengths=lengths)
    for label, shape, dtype, extra in [
            ("index form", (8, 16, 8, 2048, 64), bf16, {}),
            ("S=1", (2, 16, 8, 1, 64), bf16, {}),
            ("S=65", (2, 16, 8, 65, 64), bf16, {}),
            ("S=129", (2, 16, 8, 129, 64), bf16, {}),
            ("S=130", (2, 16, 8, 130, 64), bf16, {}),
            ("hd=32", (2, 16, 8, 300, 32), bf16, {}),
            ("S=4096", (1, 16, 8, 4096, 64), bf16, {}),
            ("hd=128", (2, 8, 8, 300, 128), bf16, {}),
            ("hd=256", (1, 8, 4, 300, 256), bf16, {}),
            ("hd=256 f32", (1, 8, 4, 300, 256), f32, {}),
            ("rep=1", (2, 8, 8, 256, 64), bf16, {}),
            ("rep=16", (2, 16, 1, 256, 64), bf16, {}),
            ("rep=16 padded", (4, 16, 1, 300, 64), bf16,
             {"lengths": [300, 1, 64, 77]}),
            ("padded window", (4, 16, 8, 700, 64), bf16,
             {"lengths": [700, 1, 333, 64], "window": 128}),
            ("padded window+soft-cap hd=128", (3, 8, 4, 500, 128), bf16,
             {"lengths": [1, 64, 450], "window": 100, "softcap": 30.0}),
            ("window", (2, 16, 8, 1000, 64), bf16, {"window": 256}),
            ("soft-cap", (2, 16, 8, 500, 64), bf16, {"softcap": 50.0}),
            ("f32", (2, 16, 8, 1024, 64), f32, {}),
            # a rank's heads in 15c: (c) bf16 training, (a) float32
            ("15c(c) split heads", (4, 8, 4, 2048, 64), bf16, {}),
            ("15c(a) split heads f32", (2, 8, 4, 512, 64), f32, {}),
            # a rank's heads in 16: (b) bf16 prefill, (a) float32 prefill
            ("16(b) split heads padded", (8, 8, 4, 2048, 64), bf16,
             {"lengths": [len(p) for p in serve_prompts(
                 get_config(ARCH), SPLIT_PROMPTS)]}),
            ("16(a) split heads padded f32", (4, 8, 4, 900, 64), f32,
             {"lengths": list(SPLIT_LENS)}),
            ("f32 window+soft-cap", (2, 4, 2, 700, 64), f32,
             {"window": 100, "softcap": 30.0}),
            ("f32 padded", (4, 16, 8, 700, 64), f32,
             {"lengths": [700, 1, 333, 64]}),
            ("f32 padded window", (4, 16, 8, 700, 64), f32,
             {"lengths": [700, 1, 333, 64], "window": 128})]:
        _, row, _ = flash_check(label, *shape, dtype, g, dev, **extra)
        if dtype == bf16:
            worst_row = max(worst_row, row)
    log(f"[kernels] flash_attention bfloat16: worst row's relative L2 error "
        f"over every case {worst_row:.3e} (bound {BF16_ROW_TOL})")
    first = ops.flash_attention(q, k, v, **kw)
    if not torch.equal(first, ops.flash_attention(q, k, v, **kw)):
        fail("flash_attention: two calls on the same inputs differ")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = {
        "kernel": lambda: ops.flash_attention(q, k, v, **kw),
        "index form": lambda: ops.flash_attention(q, k, v),
        "SDPA": lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)}
    # the float32 (FMA) kernel at the same shape and prompts
    qf, kf, vf = q.float(), k.float(), v.float()
    calls["float32 kernel"] = lambda: ops.flash_attention(qf, kf, vf, **kw)
    # events (host issue included) and the profiler's device time, taken in
    # turns: each call once in order, then once in reverse order
    ev = {n: [] for n in calls}
    dv = {n: [] for n in calls}
    for n in (*calls, *reversed(calls)):
        ev[n].append(time_ms(calls[n], 10))
        dv[n].append(device_ms(calls[n], 10))
    ev = {n: sum(t) / len(t) for n, t in ev.items()}
    dv = {n: sum(t) / len(t) for n, t in dv.items()}
    for n in calls:
        log(f"[kernels] flash_attention timing at (8, 16, 8, 2048, 64), "
            f"{n}: {ev[n]:.4f} ms by CUDA events, {dv[n]:.4f} ms device "
            f"time")
    flash_ms, flash_index_ms, flash_lib = (ev["kernel"], ev["index form"],
                                           ev["SDPA"])
    flash_plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 3)
    b, h, s, hd = q.shape
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    # what these prompts need: causal over the real tokens, one key for
    # each padded query
    pairs = sum(int(n) * (int(n) + 1) // 2 + (s - int(n)) for n in lengths)
    f_bound, f_by = bound_ms(n_bytes, 4 * h * hd * pairs, BF16_OPS_PER_S)
    log(f"[kernels] flash_attention index form at the same shape: "
        f"{flash_index_ms:.4f} ms (causal over all {s} positions, as SDPA "
        f"computes it: {flash_index_ms / flash_lib:.2f}x SDPA)")
    flash = dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:93",
                 max_abs_err=worst, ms=flash_ms, plain_ms=flash_plain,
                 bound_ms=f_bound, bound_by=f_by, library_ms=flash_lib,
                 shape=[b, h, k.shape[1], s, hd])

    # -- dispatch positions: one priority slot of granite's prefill (8
    # groups x 2048 tokens, E = 32) and of its decode (8 x 1), and edges
    cases = []
    for label, r, t, e, frac, base_hi in [
            ("prefill slot (8, 2048), E=32", 8, 2048, 32, 1.0, 0),
            ("decode slot (8, 1), E=32", 8, 1, 32, 1.0, 0),
            ("non-zero base", 8, 2048, 32, 1.0, 100),
            ("E=1", 4, 3000, 1, 0.8, 3), ("E=128", 4, 3000, 128, 0.9, 3),
            ("E=300", 4, 3000, 300, 0.7, 5), ("all -1", 3, 500, 32, 0.0, 4)]:
        idx = torch.randint(0, e, (r, t), generator=g, dtype=torch.int32)
        keep = torch.rand(r, t, generator=g) < frac
        idx = torch.where(keep, idx, torch.full_like(idx, -1)).to(dev)
        base = torch.randint(0, base_hi + 1, (r, e), generator=g,
                             dtype=torch.int32).to(dev)
        gp, gf = ops.dispatch_positions(idx, base, e)
        wp, wf = ref.dispatch_positions_ref(idx, base, e)
        torch.cuda.synchronize()
        same = torch.equal(gp, wp) and torch.equal(gf, wf)
        log(f"[kernels] dispatch_positions {label} {(r, t)}: "
            f"{'exact' if same else 'DIFFERS'}")
        if not same:
            fail(f"dispatch_positions {label}: differs from the plain version")
        cases.append((idx, base, e))
    # -- all k priority levels of a MoE layer in one launch: granite's
    # prefill and decode at its capacities, a capacity the levels overflow,
    # E = 1, E = 300, and E = 5000 (the ordered-claim path)
    cfg = get_config(ARCH)
    k, e = cfg.experts_per_token, cfg.n_experts
    cap_pre = moe_mod.moe_capacity(2048, k, e, cfg.capacity_factor)
    cap_dec = moe_mod.moe_capacity(1, k, e, cfg.capacity_factor)
    level_cases = []
    for label, r, t, kk, ee, cap, frac in [
            (f"prefill (8, 2048, k={k}), E={e}, C={cap_pre}", 8, 2048, k, e,
             cap_pre, 1.0),
            (f"decode (8, 1, k={k}), E={e}, C={cap_dec}", 8, 1, k, e,
             cap_dec, 1.0),
            ("overflow C=100", 8, 2048, k, e, 100, 0.95),
            ("E=1", 4, 3000, 2, 1, 700, 0.8),
            ("E=300", 4, 3000, 4, 300, 20, 0.7),
            ("E=5000, ordered claims", 2, 3000, 3, 5000, 1, 0.5)]:
        topk = torch.randint(0, ee, (r, t, kk), generator=g,
                             dtype=torch.int32)
        keep = torch.rand(r, t, kk, generator=g) < frac
        topk = torch.where(keep, topk, torch.full_like(topk, -1)).to(dev)
        got = ops.dispatch_positions_levels(topk, ee, cap)
        want = ref.dispatch_positions_levels_ref(topk, ee, cap)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        dropped = int((~want[1]).sum())
        log(f"[kernels] dispatch_positions_levels {label} {(r, t, kk)}: "
            f"{'exact' if same else 'DIFFERS'} ({dropped} slots dropped)")
        if not same:
            fail(f"dispatch_positions_levels {label}: differs from the plain "
                 f"version")
        level_cases.append((topk, ee, cap))
    topk, ee, cap = level_cases[0]
    # a launch is shorter than its issue time: time the card by the
    # profiler, and show the event-timed issue rate beside it; the k
    # single-level launches the MoE layer made before, for comparison
    one = cases[0]
    calls = {
        "levels kernel": lambda: ops.dispatch_positions_levels(topk, ee, cap),
        "levels plain": lambda: ref.dispatch_positions_levels_ref(
            topk, ee, cap),
        f"{k} single-level launches": lambda: [
            ops.dispatch_positions(*one) for _ in range(k)]}
    issue = {n: time_ms(fn, 100) for n, fn in calls.items()}
    dev_t = {n: device_ms(fn, 50) for n, fn in calls.items()}
    for n in calls:
        log(f"[kernels] dispatch_positions {n} at (8, 2048, k={k}): "
            f"{dev_t[n]:.4f} ms device time, {issue[n]:.4f} ms a call back "
            f"to back by CUDA events (host issue included)")
    r, t, kk = topk.shape
    # read T k experts, write T k positions and keep flags, E fills
    p_bound, p_by = bound_ms(r * t * kk * (4 + 4 + 1) + r * ee * 4, 0)
    positions = dict(name="dispatch_positions", route="cuda",
                     source="src/repro_torch/kernels/csrc/psts_dispatch.cu",
                     replaces="src/repro/kernels/psts_dispatch.py:46",
                     max_abs_err=0.0, ms=dev_t["levels kernel"],
                     plain_ms=dev_t["levels plain"], bound_ms=p_bound,
                     bound_by=p_by, library_ms=None, shape=[r, t, kk, ee],
                     issue_ms=issue["levels kernel"])
    for rec in (flash, positions):
        log(f"[kernels] {rec['name']} at {rec['shape']}: {rec['ms']:.4f} "
            f"ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']}, bound {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']})")
    return [flash, positions]


class Counted:
    """Counts an LM's prefill calls and decode steps and times each call
    between two synchronisations (instance attributes shadow the methods
    that the engines call)."""

    def __init__(self, lm):
        self.lm = lm
        self.calls = {"prefill": 0, "decode": 0}
        self.seconds = {"prefill": 0.0, "decode": 0.0}
        self.prefill_tokens = 0
        self._methods = {"prefill": lm.prefill, "decode": lm.decode_step}
        lm.prefill = self._wrap("prefill")
        lm.decode_step = self._wrap("decode")

    def _wrap(self, kind):
        method = self._methods[kind]

        def call(cache, tokens, lengths):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = method(cache, tokens, lengths)
            torch.cuda.synchronize()
            self.seconds[kind] += time.perf_counter() - t0
            self.calls[kind] += 1
            if kind == "prefill":
                self.prefill_tokens += int(np.sum(lengths))
            return out
        return call

    def restore(self):
        del self.lm.prefill, self.lm.decode_step


def serve_prompts(cfg, n=SERVE_REQUESTS):
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LO, PROMPT_HI + 1, size=n)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in lens]


def run_serve(lm, prompts):
    return serve(lm, prompts, max_new=SERVE_NEW, slots=SERVE_SLOTS,
                 max_len=SERVE_MAX_LEN, replicas=SERVE_REPLICAS)


def phase_serve(dev):
    """The serving path at full width through launch.serve's entry
    function; returns (lm, prompts, launches)."""
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    lm.weights()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"[serve] {ARCH}: {n_params} parameters ({cfg.param_dtype}), "
        f"compute {cfg.dtype}, KV cache {cfg.kv_cache_dtype}; init on the "
        f"card in {time.perf_counter() - t0:.2f}s")
    prompts = serve_prompts(cfg)
    torch.cuda.reset_peak_memory_stats()
    counted = Counted(lm)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary, done, sched = run_serve(lm, prompts)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    counted.restore()
    peak = torch.cuda.max_memory_allocated()
    n_pre, n_dec = counted.calls["prefill"], counted.calls["decode"]
    n_moe = cfg.n_layers  # every granite layer is MoE
    # the serving and sweep paths launch no backward kernel
    want = {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "mamba_scan_bwd": 0,
            "prefix_scan": 0, "dispatch_work_prefix": 0, "mamba_scan": 0,
            "flash_attention": cfg.n_layers * n_pre,
            "flash_attention_tc": cfg.n_layers * n_pre,
            "dispatch_positions": n_moe * (n_pre + n_dec)}
    log(f"[serve] {len(done)} of {SERVE_REQUESTS} requests finished; "
        f"{n_pre} prefill calls, {n_dec} decode steps; launches {launches}")
    if launches != want or min(want["flash_attention"],
                               want["dispatch_positions"]) <= 0:
        fail(f"serve launch counts {launches}, expected {want}")
    if len(done) != SERVE_REQUESTS or summary["finished"] != SERVE_REQUESTS:
        fail(f"{len(done)} of {SERVE_REQUESTS} requests finished")
    tokens = {r.rid: list(r.generated) for r in done}
    if any(len(t) != SERVE_NEW for t in tokens.values()):
        fail("a request stopped before its max_new tokens")
    if any(not 0 <= x < cfg.vocab_padded for t in tokens.values()
           for x in t):
        fail("a generated token lies outside the vocabulary")
    gen = sum(len(t) for t in tokens.values())
    dec_tokens = gen - len(done)   # each request's first token: prefill
    log(f"[serve] wall {wall:.3f}s for {gen} generated tokens "
        f"({gen / wall:.1f} tok/s); prefill {counted.prefill_tokens} prompt "
        f"tokens in {counted.seconds['prefill']:.3f}s "
        f"({counted.prefill_tokens / counted.seconds['prefill']:.1f} tok/s);"
        f" decode {dec_tokens} tokens in {counted.seconds['decode']:.3f}s "
        f"({dec_tokens / counted.seconds['decode']:.1f} tok/s, "
        f"{1e3 * counted.seconds['decode'] / n_dec:.2f} ms/step); peak "
        f"device memory {peak / 2**30:.2f} GiB; replica loads "
        f"{summary['replica_loads']}; CLI record {json.dumps(summary)}")

    t0 = time.perf_counter()
    _, again, _ = run_serve(lm, prompts)
    if {r.rid: list(r.generated) for r in again} != tokens:
        fail("a second serving run generated other tokens")
    log(f"[serve] second run repeats all {gen} tokens "
        f"({time.perf_counter() - t0:.2f}s)")
    return lm, prompts, launches


def phase_serve_profile(lm, prompts):
    """Device time by kernel over a short serving run: one engine, the
    first 8 prompts, 8 new tokens each (one prefill call, 7 decode
    steps)."""
    def short():
        Engine(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN).run(
            [GenRequest(i, p, 8) for i, p in enumerate(prompts[:8])])
        torch.cuda.synchronize()
    short()
    t0 = time.perf_counter()
    short()
    wall = time.perf_counter() - t0
    device_time_table(short, wall, "serve-profile",
                      watch=("flash_fwd", "positions_levels"))


def phase_serve_vs_plain(dev):
    """The whole serving path's kernels against their plain versions: the
    full-width config cut to 2 layers, in float32, with the same weights on
    the card and on the CPU; 4 right-padded prompts prefilled on each.

    Checks: (a) every layer's routing on the card equals the plain dispatch
    run on the card's own router logits, exactly; (b) the router logits and
    the last-token logits of the two devices agree within 1e-4 x max|value|
    (float32 on both; sums in other orders over 1024-wide products and a
    49,408-wide vocabulary); (c) the routing of the two devices is equal,
    unless a prompt's top-k order differs at a near tie (a gap below 1e-4
    between two of its top-(k+1) router logits), which float rounding may
    decide either way: such a prompt is reported and left out of (b)'s
    last-token check, and of (b) and (c) in the layers after the tie (its
    hidden states there come from other experts on the two devices)."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32",
                              kv_cache_dtype="float32")
    card = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    host = LM(cfg, device="cpu")
    host.load_state_dict({n: t.cpu() for n, t in card.state_dict().items()})
    rng = np.random.default_rng(2)
    lens = rng.integers(100, 513, size=4).astype(np.int32)
    toks = np.zeros((4, 512), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)

    calls = []
    plain_dispatch = moe_mod.dispatch_grouped

    def recording(logits, **kw):
        res = plain_dispatch(logits, **kw)
        calls.append((logits, kw, res))
        return res
    moe_mod.dispatch_grouped = recording
    try:
        t0 = time.perf_counter()
        logit_card, _ = card.prefill(card.init_cache(4, 512), toks, lens)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        on_card, calls[:] = list(calls), []
        # The host's first float32 prefill in a process that has run the
        # card's is, now and then, not the host's usual result. In fresh
        # processes on the card machine (experiments/torch_phase6_probe.py,
        # variants "card" and "card_hashfirst") the first host call parted
        # from the common bits in 1 of 48 and 2 of 40, its router logits
        # ~5e-5 x max off the card; the second and third calls never did
        # (0 of 136, 48 of them with MKL_DYNAMIC=FALSE), nor did CPU-only
        # processes (0 of 92). Digested op by op, the first output that
        # parts is aten.cos (RoPE's cos of the angles) on the CPU, whose
        # first call in such a process is not always bit for bit its
        # later ones. So the compared prefill is the host's second; the
        # warm-up's result is dropped, and whether it matched is logged.
        warm, _ = host.prefill(host.init_cache(4, 512), toks, lens)
        calls[:] = []
        t0 = time.perf_counter()
        logit_host, _ = host.prefill(host.init_cache(4, 512), toks, lens)
        t_host = time.perf_counter() - t0
        on_host = list(calls)
        warm_same = torch.equal(warm, logit_host)
    finally:
        moe_mod.dispatch_grouped = plain_dispatch
    if len(on_card) != cfg.n_layers or len(on_host) != cfg.n_layers:
        fail("the 2-layer prefill did not dispatch once per layer")

    fields = ("expert_idx", "slot_idx", "keep")
    k = cfg.experts_per_token
    diverged = set()
    for layer, ((lc, kw, rc), (lh, _, rh)) in enumerate(zip(on_card,
                                                            on_host)):
        # (a) the positions kernel inside the dispatch, against the plain
        # dispatch on the same router logits
        plain = moe_dispatch.dispatch_grouped(lc.cpu(), **kw)
        for f in fields:
            if not torch.equal(getattr(rc, f).cpu(), getattr(plain, f)):
                fail(f"layer {layer}: card routing {f} differs from the "
                     f"plain dispatch on the same router logits")
        # (b) router logits, of the prompts routed alike so far
        live = [gi for gi in range(len(lens)) if gi not in diverged]
        if not live:
            fail("every prompt diverged at a near tie; nothing left to "
                 "compare")
        lc = lc.cpu()
        r_err = ((lc[live] - lh[live]).abs().max().item()
                 / lh[live].abs().max().item())
        if not r_err <= LOGIT_TOL:
            fail(f"layer {layer}: router logits differ by {r_err:.3e} x max")
        # (c) routing across devices
        same = [all(torch.equal(getattr(rc, f)[gi].cpu(), getattr(rh, f)[gi])
                    for f in fields) for gi in range(len(lens))]
        top = torch.topk(lh, k + 1, dim=-1)
        gaps = (top.values[..., :-1] - top.values[..., 1:]).min(-1).values
        flipped = (torch.topk(lc, k, dim=-1).indices
                   != top.indices[..., :k]).any(-1)
        for gi in live:
            if same[gi]:
                continue
            if not flipped[gi].any():
                fail(f"layer {layer} prompt {gi}: routing differs with the "
                     f"same top-k choices")
            gap = gaps[gi][flipped[gi]].max().item()
            if not gap < 1e-4:
                fail(f"layer {layer} prompt {gi}: top-k differs at a gap "
                     f"of {gap:.3e}, not a near tie")
            diverged.add(gi)
            log(f"[serve-vs-plain] layer {layer} prompt {gi}: top-k order "
                f"decided by a near tie (gap {gap:.2e}); left out of the "
                f"logits check")
        log(f"[serve-vs-plain] layer {layer}: routing equal to the plain "
            f"dispatch on the card's logits; router logits within "
            f"{r_err:.2e} x max on {len(live)} prompts; prompts routed "
            f"alike on both devices: {sum(same)}/{len(lens)}")
    keep_rows = [i for i in range(len(lens)) if i not in diverged]
    if not keep_rows:
        fail("every prompt diverged at a near tie; nothing left to compare")
    lc, lh = logit_card.cpu()[keep_rows], logit_host[keep_rows]
    err = (lc - lh).abs().max().item() / lh.abs().max().item()
    if not err <= LOGIT_TOL:
        fail(f"last-token logits differ by {err:.3e} x max|logit|")
    if not torch.equal(lc.argmax(-1), lh.argmax(-1)):
        fail("the greedy next tokens differ between the card and the CPU")
    log(f"[serve-vs-plain] {ARCH} x 2 layers f32, prompts {lens.tolist()} "
        f"(bucket 512): last-token logits within {err:.3e} x max|logit| "
        f"on {len(keep_rows)} prompts, same greedy tokens; prefill {t_card:.3f}s "
        f"on the card, {t_host:.3f}s on the CPU (its warm-up prefill "
        f"{'equal to' if warm_same else 'NOT equal to'} it to the bit)")


# ---------------------------------------------------------------------------
# the third path: falcon-mamba-7b and the selective-scan kernel
# ---------------------------------------------------------------------------

def scan_check(label, shape, dtype, g, dev, *, lengths=None):
    """The scan kernel against its plain version; returns max|err| and the
    inputs. ``lengths`` right-pads each row (da = 1, dbx = 0)."""
    b, s, n, di = shape
    da = (torch.rand(shape, generator=g, device=dev) * 0.5 + 0.5).to(dtype)
    dbx = torch.randn(shape, generator=g, device=dev).to(dtype)
    if lengths is not None:
        pad = (torch.arange(s, device=dev)[None, :]
               >= torch.as_tensor(lengths, device=dev)[:, None])
        da[pad] = 1.0
        dbx[pad] = 0.0
    got = ops.mamba_scan(da, dbx)
    want = ref.mamba_scan_ref(da, dbx)
    torch.cuda.synchronize()
    err = (got - want).abs()
    worst = err.max().item()
    del got
    log(f"[kernels] mamba_scan {label} {shape} {str(dtype)[6:]}: "
        f"max|err|={worst:.3e}")
    if not bool((err <= SCAN_TOL + SCAN_TOL * want.abs()).all()):
        fail(f"mamba_scan {label}: error beyond {SCAN_TOL} (rtol and atol)")
    if lengths is not None:
        last = want[torch.arange(b, device=dev),
                    torch.as_tensor(lengths, device=dev) - 1]
        if not torch.equal(want[:, -1], last):
            fail(f"mamba_scan {label}: padding did not carry the state")
    return worst, (da, dbx)


def phase_kernels_mamba(dev):
    """The scan kernel against its plain version at falcon-mamba-7b's
    prefill shape and at edges; times at the prefill shape. Returns its
    kernel record (launches filled in later)."""
    g = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    for label, shape, dtype, extra in [
            ("S=1", (2, 1, 16, 8192), f32, {}),
            ("S=130", (2, 130, 16, 256), f32, {}),
            ("di=36 (one channel a thread)", (3, 70, 4, 36), f32,
             {"lengths": [70, 1, 33]}),
            ("bf16", (2, 333, 16, 256), bf16, {}),
            ("bf16 di=37, padded", (2, 77, 3, 37), bf16,
             {"lengths": [5, 77]}),
            ("B=2, S=130 at full width", (2, 130, 16, 8192), f32, {}),
            ("15c(b) a rank's channels", (2, 512, 16, 4096), f32, {}),
            ("16(a) a rank's channels, padded", (4, 900, 16, 4096), f32,
             {"lengths": list(SPLIT_LENS)}),
            ("bf16 serve shape, padded", (4, 2048, 16, 8192), bf16,
             {"lengths": [2048, 256, 1000, 1731]})]:
        scan_check(label, shape, dtype, g, dev, **extra)
        torch.cuda.empty_cache()
    shape = (SSM_SLOTS, PROMPT_HI, 16, 8192)
    worst, (da, dbx) = scan_check("prefill shape, padded", shape, f32, g,
                                  dev, lengths=[2048, 256, 1000, 1731])
    scan_ms = time_ms(lambda: ops.mamba_scan(da, dbx), 10)
    plain_ms = time_ms(lambda: ref.mamba_scan_ref(da, dbx), 2)
    # da and dbx read once, h written once (float32): 12 B an element, one
    # fma each
    n_el = da.numel()
    m_bound, m_by = bound_ms(12 * n_el, 2 * n_el, FP32_OPS_PER_S)
    del da, dbx
    torch.cuda.empty_cache()
    rec = dict(name="mamba_scan", route="cuda",
               source="src/repro_torch/kernels/csrc/mamba_scan.cu",
               replaces="src/repro/kernels/mamba_scan.py:56",
               max_abs_err=worst, ms=scan_ms, plain_ms=plain_ms,
               bound_ms=m_bound, bound_by=m_by, library_ms=None,
               shape=list(shape))
    log(f"[kernels] mamba_scan at {rec['shape']}: {scan_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library None (no PyTorch call computes the "
        f"recurrence), bound {m_bound:.4f} ms ({m_by})")
    return rec


def phase_falcon_serve(dev):
    """falcon-mamba-7b at full width through launch.serve's entry function;
    returns (lm, prompts, launches)."""
    cfg = get_config(SSM_ARCH)
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    lm.weights()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"[falcon-serve] {SSM_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, N {cfg.ssm_state}, dt_rank "
        f"{cfg.dt_rank}, vocab {cfg.vocab_size}: {n_params} parameters "
        f"(ModelConfig.n_params {cfg.n_params()} leaves out conv_b) in "
        f"{cfg.param_dtype}, compute and SSM state {cfg.dtype}; init and "
        f"compute copy on the card in {time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts = serve_prompts(cfg, SSM_REQUESTS)

    def run():
        return serve(lm, prompts, max_new=SSM_NEW, slots=SSM_SLOTS,
                     max_len=SERVE_MAX_LEN, replicas=SERVE_REPLICAS)

    torch.cuda.reset_peak_memory_stats()
    counted = Counted(lm)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary, done, _ = run()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    counted.restore()
    peak = torch.cuda.max_memory_allocated()
    n_pre, n_dec = counted.calls["prefill"], counted.calls["decode"]
    # the serving and sweep paths launch no backward kernel
    want = {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "mamba_scan_bwd": 0,
            "prefix_scan": 0, "dispatch_work_prefix": 0,
            "dispatch_positions": 0, "flash_attention": 0,
            "flash_attention_tc": 0, "mamba_scan": cfg.n_layers * n_pre}
    log(f"[falcon-serve] {len(done)} of {SSM_REQUESTS} requests finished; "
        f"{n_pre} prefill calls, {n_dec} decode steps; launches {launches}")
    if launches != want or n_pre <= 0:
        fail(f"falcon-serve launch counts {launches}, expected {want}")
    if len(done) != SSM_REQUESTS or summary["finished"] != SSM_REQUESTS:
        fail(f"{len(done)} of {SSM_REQUESTS} requests finished")
    tokens = {r.rid: list(r.generated) for r in done}
    if any(len(t) != SSM_NEW for t in tokens.values()):
        fail("a request stopped before its max_new tokens")
    if any(not 0 <= x < cfg.vocab_padded for t in tokens.values()
           for x in t):
        fail("a generated token lies outside the vocabulary")
    gen = sum(len(t) for t in tokens.values())
    dec_tokens = gen - len(done)
    log(f"[falcon-serve] wall {wall:.3f}s for {gen} generated tokens "
        f"({gen / wall:.1f} tok/s); prefill {counted.prefill_tokens} prompt "
        f"tokens in {counted.seconds['prefill']:.3f}s "
        f"({counted.prefill_tokens / counted.seconds['prefill']:.1f} tok/s,"
        f" {1e3 * counted.seconds['prefill'] / n_pre:.1f} ms/call); decode "
        f"{dec_tokens} tokens in {counted.seconds['decode']:.3f}s "
        f"({dec_tokens / counted.seconds['decode']:.1f} tok/s, "
        f"{1e3 * counted.seconds['decode'] / n_dec:.2f} ms/step); peak "
        f"device memory {peak / 2**30:.2f} GiB; CLI record "
        f"{json.dumps(summary)}")
    if not peak < MEMORY_LIMIT:
        fail(f"peak device memory {peak / 1e9:.2f} GB, not under 80 GB")

    t0 = time.perf_counter()
    _, again, _ = run()
    if {r.rid: list(r.generated) for r in again} != tokens:
        fail("a second falcon-mamba serving run generated other tokens")
    log(f"[falcon-serve] second run repeats all {gen} tokens "
        f"({time.perf_counter() - t0:.2f}s)")

    def short():
        Engine(lm, slots=SSM_SLOTS, max_len=SERVE_MAX_LEN).run(
            [GenRequest(i, p, 8) for i, p in enumerate(prompts[:SSM_SLOTS])])
        torch.cuda.synchronize()
    short()
    t0 = time.perf_counter()
    short()
    device_time_table(short, time.perf_counter() - t0, "falcon-profile")
    return launches


def _leaves(cache):
    if isinstance(cache, dict):
        return [t for key in sorted(cache) for t in _leaves(cache[key])]
    return list(cache)


def _max_rel(got, want) -> float:
    return (got.cpu().float() - want.float()).abs().max().item() / max(
        want.abs().max().item(), 1e-30)


def lm_vs_plain(tag, cfg, dev, *, decode_steps, check_cache):
    """``cfg`` on the card and on the CPU with the card's weights: 4
    right-padded prompts of 100-512 tokens prefilled, then ``decode_steps``
    greedy steps fed the CPU's tokens; logits within 1e-4 x max|logit| at
    each step. Returns (the card's launch counts over the prefill, the MoE
    dispatch calls of each device's prefill)."""
    card = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    host = LM(cfg, device="cpu")
    host.load_state_dict({n: t.cpu() for n, t in card.state_dict().items()})
    rng = np.random.default_rng(2)
    lens = rng.integers(100, 513, size=4).astype(np.int32)
    toks = np.zeros((4, 512), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)

    calls = []
    plain_dispatch = moe_mod.dispatch_grouped

    def recording(logits, **kw):
        res = plain_dispatch(logits, **kw)
        calls.append(res)
        return res
    moe_mod.dispatch_grouped = recording
    try:
        c_card = card.init_cache(4, 512 + decode_steps)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        lc, c_card = card.prefill(c_card, toks, lens)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        launches = ops.launch_counts()
        on_card, calls[:] = list(calls), []
        c_host = host.init_cache(4, 512 + decode_steps)
        t0 = time.perf_counter()
        lh, c_host = host.prefill(c_host, toks, lens)
        t_host = time.perf_counter() - t0
        on_host = list(calls)
    finally:
        moe_mod.dispatch_grouped = plain_dispatch
    err = _max_rel(lc, lh)
    log(f"[{tag}] prefill of prompts {lens.tolist()} (bucket 512): "
        f"last-token logits within {err:.3e} x max|logit|; {t_card:.3f}s on "
        f"the card, {t_host:.3f}s on the CPU; card launches {launches}")
    if not err <= LOGIT_TOL:
        fail(f"{tag}: prefill logits differ by {err:.3e} x max|logit|")
    if check_cache:
        for name, got, want in zip(("state", "conv"), _leaves(c_card),
                                   _leaves(c_host)):
            c_err = _max_rel(got, want)
            log(f"[{tag}] SSM {name} cache after prefill within {c_err:.3e} "
                f"x max")
            if not c_err <= SCAN_TOL:
                fail(f"{tag}: SSM {name} cache differs by {c_err:.3e} x max")
    for step in range(decode_steps):
        nxt = lh.reshape(4, -1).argmax(-1).numpy().astype(np.int32)
        lc, c_card = card.decode_step(c_card, nxt[:, None], lens + step)
        lh, c_host = host.decode_step(c_host, nxt[:, None], lens + step)
        err = _max_rel(lc, lh)
        log(f"[{tag}] decode step {step}: logits within {err:.3e} x "
            f"max|logit|")
        if not err <= LOGIT_TOL:
            fail(f"{tag}: decode step {step} logits differ by {err:.3e}")
    return launches, on_card, on_host


def phase_falcon_vs_plain(dev):
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=2,
                              dtype="float32")
    launches, _, _ = lm_vs_plain("falcon-vs-plain", cfg, dev,
                                 decode_steps=SSM_DECODE_STEPS,
                                 check_cache=True)
    if launches["mamba_scan"] != cfg.n_layers:
        fail(f"falcon-vs-plain: {launches['mamba_scan']} scan launches, "
             f"expected {cfg.n_layers}")


def phase_hybrid_vs_plain(dev):
    cfg = get_config(HYBRID_ARCH).smoke()
    launches, on_card, on_host = lm_vs_plain("hybrid-vs-plain", cfg, dev,
                                             decode_steps=2,
                                             check_cache=False)
    periods = cfg.n_layers // cfg.attn_every
    n_moe = cfg.n_layers // cfg.moe_every
    # the serving and sweep paths launch no backward kernel
    want = {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "mamba_scan_bwd": 0,
            "prefix_scan": 0, "dispatch_work_prefix": 0,
            "mamba_scan": cfg.n_layers - periods,
            "flash_attention": periods, "flash_attention_tc": 0,
            "dispatch_positions": n_moe}
    if launches != want:
        fail(f"hybrid-vs-plain launch counts {launches}, expected {want}")
    if len(on_card) != n_moe or len(on_host) != n_moe:
        fail("the hybrid prefill did not dispatch once per MoE sub-layer")
    for i, (rc, rh) in enumerate(zip(on_card, on_host)):
        for f in ("expert_idx", "slot_idx", "keep"):
            if not torch.equal(getattr(rc, f).cpu(), getattr(rh, f)):
                fail(f"hybrid-vs-plain: MoE sub-layer {i} routing {f} "
                     f"differs between the card and the CPU")
    log(f"[hybrid-vs-plain] {HYBRID_ARCH} smoke ({cfg.n_layers} sub-layers:"
        f" {cfg.n_layers - periods} Mamba, {periods} attention, {n_moe} "
        f"MoE): routing of every MoE sub-layer equal on both devices; card "
        f"launches {launches}")


def events_scenario() -> lab.Scenario:
    cluster = lab.ClusterSpec(n_nodes=EV_NODES, power_low=1, power_high=10,
                              power_seed=0)
    rate = EV_LOAD * float(cluster.resolve_powers().sum()) / EV_WORK_MEAN
    return lab.Scenario(
        cluster=cluster,
        workload=lab.WorkloadSpec(process="poisson", horizon=EV_HORIZON,
                                  work_mean=EV_WORK_MEAN,
                                  params={"rate": rate}),
        policy=lab.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.1}))


def phase_events(dev, smi: str):
    base = events_scenario()
    t0 = time.perf_counter()
    ev = lab.sweep(base=base, grid={"seed": range(EV_SMALL_SEEDS)},
                   backend="auto", device=dev)
    ev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ba = lab.sweep(base=base, grid={"seed": range(EV_BATCH_SEEDS)},
                   backend="auto", device=dev)
    torch.cuda.synchronize()
    ba_s = time.perf_counter() - t0
    if [r.backend for r in ev] != ["events"] * EV_SMALL_SEEDS:
        fail(f"events: a {EV_SMALL_SEEDS}-seed sweep ran on "
             f"{[r.backend for r in ev]}, expected events")
    if [r.backend for r in ba] != ["batched"] * EV_BATCH_SEEDS:
        fail(f"events: an {EV_BATCH_SEEDS}-seed sweep ran on "
             f"{[r.backend for r in ba]}, expected batched")
    tasks = 0
    for seed, (e, b) in enumerate(zip(ev, ba)):
        gap_mk = (b["makespan"] - e["makespan"]) / e["makespan"]
        gap_mr = (b["mean_response"] - e["mean_response"]) / e["mean_response"]
        if e["arrived"] != b["arrived"]:
            fail(f"events: seed {seed} arrived {e['arrived']} on events, "
                 f"{b['arrived']} on batched")
        if e["completed"] != e["arrived"]:
            fail(f"events: seed {seed} completed {e['completed']} of "
                 f"{e['arrived']} tasks")
        if not (e["migrations"] > 0 and e["trigger_fires"] > 0):
            fail(f"events: seed {seed} made {e['migrations']} migrations "
                 f"and {e['trigger_fires']} trigger fires")
        tasks += e["arrived"]
        log(f"[events] seed {seed}: {e['arrived']} tasks; makespan "
            f"{e['makespan']!r} events / {b['makespan']!r} batched (gap "
            f"{gap_mk!r}); mean response {e['mean_response']!r} / "
            f"{b['mean_response']!r} (gap {gap_mr!r}); "
            f"{e['trigger_fires']} trigger fires, {e['migrations']} "
            f"migrations")
    log(f"[events] {EV_NODES} nodes: {ev_s / EV_SMALL_SEEDS!r} s per events "
        f"run, {ev_s / tasks * 1e6!r} us per task (host engine); batched "
        f"sweep of {EV_BATCH_SEEDS} seeds {ba_s!r} s on "
        f"{torch.cuda.get_device_name(0)} ({smi})")

    # seed 0 again, traced, probed and scraped: same metrics, to the byte
    obs_sc = base.replace(obs=lab.ObsSpec(trace=True, ring=4096,
                                          probe_every=1.0, metrics=True))
    t0 = time.perf_counter()
    rt, wl, ins, (failures, joins, resizes) = build_events_runtime(obs_sc)
    rt.run(wl, failures=failures, joins=joins, resizes=resizes)
    obs_run = assemble_events_result(
        obs_sc, rt, wl, ins, backend="events",
        backend_options={"model": "discrete-event"})
    obs_s = time.perf_counter() - t0
    if json.dumps(obs_run.metrics) != json.dumps(ev[0].metrics):
        fail("events: seed 0 with obs on gave other metrics than without")
    scrape = ins.collector.scrape()
    fams = parse_openmetrics(scrape)
    if fams["sched_completed"]["samples"][0][2] != obs_run["completed"]:
        fail("events: the OpenMetrics scrape disagrees with the summary")
    obs = obs_run.extras["obs"]
    log(f"[events] seed 0 with obs on: metrics byte-identical; "
        f"{obs['trace_events']} trace events kept ({obs['trace_dropped']} "
        f"dropped), {len(obs['probes']['t'])} probe samples, scrape of "
        f"{len(fams)} families parses; {obs_s!r} s")

    t0 = time.perf_counter()
    leg = [lab.run(base, backend="legacy") for _ in range(2)]
    leg_s = (time.perf_counter() - t0) / 2
    if leg[0].to_dict() != leg[1].to_dict():
        fail("events: legacy reruns of seed 0 differ")
    for k in ("crossover", "speedup", "overhead"):
        if not math.isfinite(leg[0].extras[k]):
            fail(f"events: legacy {k} is {leg[0].extras[k]}")
    x = {k: float(leg[0].extras[k])
         for k in ("crossover", "speedup", "overhead")}
    log(f"[events] legacy seed 0: crossover {x['crossover']!r}, speedup "
        f"{x['speedup']!r}, overhead {x['overhead']!r}; {leg_s!r} s per run")
    return ev[0]


def trace_scenario() -> lab.Scenario:
    """trace-12.5k: the excerpt rate-scaled to the 12,500-node cell."""
    return lab.Scenario(
        cluster=lab.ClusterSpec(n_nodes=N_NODES, power_low=1, power_high=10,
                                power_seed=0),
        workload=lab.WorkloadSpec(
            trace=lab.TraceRef(path=str(TRACE_FILE), format="google",
                               params={"eviction_mode": "end"},
                               scale=TRACE_SCALE),
            horizon=TRACE_HORIZON),
        policy=lab.PolicySpec("psts", params={"floor": 0.1}))


def phase_trace_sweep(dev, smi: str):
    """12a: a seed sweep over a rate-scaled real trace on the card. The
    engine call inside the sweep is timed (and its inputs kept for the
    checks) by wrapping the batched backend's ``simulate_batch``."""
    base = trace_scenario()
    calls = []
    engine = lab_backends.simulate_batch

    def timed(slot, works, powers, cfg, power_scale=None, *, device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm = engine(slot, works, powers, cfg, power_scale=power_scale,
                    device=device)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, slot, works, powers, cfg,
                      power_scale))
        return bm

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    lab_backends.simulate_batch = timed
    try:
        with warnings.catch_warnings():
            # the horizon keeps the first 200 s of the scaled trace on
            # purpose; the lab warns of every task it drops
            warnings.filterwarnings("ignore",
                                    message=".*arrive at/after horizon")
            t0 = time.perf_counter()
            results = lab.sweep(base=base,
                                grid={"seed": range(TRACE_SEEDS)},
                                backend="auto", device=dev,
                                fifo_dispatch=True)
            wall = time.perf_counter() - t0
    finally:
        lab_backends.simulate_batch = engine
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if [r.backend for r in results] != ["batched"] * TRACE_SEEDS:
        fail(f"trace: the sweep ran on {sorted({r.backend for r in results})}"
             f", expected batched")
    if len(calls) != 1:
        fail(f"trace: {len(calls)} engine calls, expected one batched call")
    engine_s, slot, works, powers, cfg, scale = calls[0]
    ignored = results[0].backend_options.get("ignored", [])
    for flag in TRACE_IGNORED:
        if flag not in ignored:
            fail(f"trace: backend_options['ignored'] lacks {flag!r}: "
                 f"{ignored}")
    # the serving and sweep paths launch no backward kernel
    want = {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "mamba_scan_bwd": 0,
            "prefix_scan": 1 + cfg.n_slots,
            "dispatch_work_prefix": 1 + cfg.n_slots,
            "dispatch_positions": 0, "flash_attention": 0,
            "flash_attention_tc": 0, "mamba_scan": 0}
    if launches != want:
        fail(f"trace: launch counts {launches}, expected {want}")
    tasks = [r["arrived"] for r in results]
    for r in results:
        m = r.metrics
        if not (m["completed"] > 0 and all(
                math.isfinite(m[k]) for k in ("makespan", "mean_response",
                                              "p99_response",
                                              "moved_units"))):
            fail(f"trace: non-finite or empty result: {m}")
    fires = [r["trigger_fires"] for r in results]
    # offered load: the work that arrives over the horizon, and in the
    # busiest slot, over the cluster's capacity for that time
    per_slot = np.stack([np.bincount(slot[b][slot[b] < cfg.n_slots],
                                     weights=works[b][slot[b] < cfg.n_slots],
                                     minlength=cfg.n_slots)
                         for b in range(works.shape[0])])
    cap = float(np.sum(powers)) * cfg.dt
    load = per_slot.sum(axis=1) / (cap * cfg.n_slots)
    log(f"[trace] offered load over the horizon {float(load.min())!r}.."
        f"{float(load.max())!r}, busiest slot "
        f"{float(per_slot.max()) / cap!r} of "
        f"capacity, slots above capacity per seed "
        f"{(per_slot > cap).sum(axis=1).tolist()}")
    log(f"[trace] {TRACE_SEEDS} seeds x {N_NODES} nodes x {cfg.n_slots} "
        f"slots, excerpt scaled {TRACE_SCALE}x: (B, M) = {works.shape}, "
        f"{sum(tasks)} tasks ({min(tasks)}..{max(tasks)} a seed); wall "
        f"{wall!r} s = host scaling and lowering {wall - engine_s!r} s + "
        f"engine call {engine_s!r} s (transfers included); peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}; ignored "
        f"{ignored}")
    log(f"[trace] trigger fires per seed {fires}; mean response per seed "
        f"{[r['mean_response'] for r in results]}; on "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    for s in TRACE_SAMPLED:
        t0 = time.perf_counter()
        sm = simulate_scalar(slot[s], works[s], powers, cfg,
                             power_scale=scale)
        got = results[s].metrics
        for k in FIELDS:
            if not np.isclose(got[k], sm[k], rtol=1e-6, atol=0.0):
                fail(f"trace: seed {s} {k}: batched {got[k]!r} vs scalar "
                     f"{sm[k]!r}")
        exact = all(got[k] == sm[k] for k in ("trigger_fires", "moved_units",
                                               "makespan", "completed"))
        log(f"[trace] seed {s} matches simulate_scalar at rtol 1e-6 "
            f"({time.perf_counter() - t0:.1f}s; fires, moved volume, "
            f"makespan and completions bit-identical: {exact}): "
            + ", ".join(f"{k}={got[k]!r}/{sm[k]!r}" for k in FIELDS))
    tensors = to_tensors(slot, works, powers, scale, device=dev)
    del slot, works
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _simulate_batch_torch(*tensors, cfg)
    torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    for k, v in zip(FIELDS, (v.cpu().numpy() for v in out[:6])):
        prev = np.array([r[k] for r in results], dtype=np.float64)
        if not np.array_equal(prev, v.astype(np.float64)):
            fail(f"trace: engine rerun differs in {k}")
    log(f"[trace] engine rerun on the same tensors bit-identical; engine "
        f"time {rerun_s!r} s (tensors already on the card)")
    return launches


def replay_scenario(policy: str, mode: str) -> lab.Scenario:
    """trace-replay-16: the whole excerpt, constrained, with churn."""
    return lab.Scenario(
        name=f"trace/{policy}/{mode}",
        cluster=lab.ClusterSpec(powers=REPLAY_POWERS, attrs=REPLAY_ATTRS,
                                bandwidth=256.0),
        workload=lab.WorkloadSpec(
            trace=lab.TraceRef(
                path=str(TRACE_FILE), format="google",
                params={"constraints_path": str(TRACE_CONSTRAINTS),
                        "eviction_mode": "requeue"},
                machine_events=str(TRACE_MACHINES)),
            horizon=None),
        policy=lab.PolicySpec(policy, trigger_period=2.0,
                              params={"floor": 0.05}
                              if policy == "psts" else {},
                              constraint_mode=mode))


def phase_trace_replay(smi: str):
    """12b: the excerpt replayed on the host event engine."""
    tier0 = {}
    for policy, mode in (("psts", "aware"), ("arrival_only", "blind")):
        sc = replay_scenario(policy, mode)
        t0 = time.perf_counter()
        r = lab.run(sc)
        run_s = time.perf_counter() - t0
        if r.backend != "events":
            fail(f"replay: ran on {r.backend}")
        if r["completed"] != r["arrived"]:
            fail(f"replay: {policy}/{mode} completed {r['completed']} of "
                 f"{r['arrived']}")
        for k in ("evictions", "failures", "joins", "resizes"):
            if not r[k] > 0:
                fail(f"replay: {policy}/{mode} {k} = {r[k]}")
        for k in ("wait_by_tier", "tier_counts"):
            if k not in r.extras:
                fail(f"replay: {policy}/{mode} extras lack {k}")
        tier0[(policy, mode)] = r.extras["wait_by_tier"]["0"]["mean_wait"]
        log(f"[replay] {policy}/{mode}: {r['arrived']} tasks, "
            f"{r['evictions']} evictions, {r['failures']} failures, "
            f"{r['joins']} joins, {r['resizes']} resizes, mean wait "
            f"{r['mean_wait']!r}, tier-0 mean wait "
            f"{tier0[(policy, mode)]!r}, {r['migrations']} migrations; "
            f"{run_s!r} s (host engine; {smi})")
    if not tier0[("psts", "aware")] < tier0[("arrival_only", "blind")]:
        fail(f"replay: psts/aware tier-0 wait {tier0[('psts', 'aware')]} "
             f"not below arrival_only/blind's "
             f"{tier0[('arrival_only', 'blind')]}")


def geo_member(i: int, load: float) -> lab.Scenario:
    cluster = lab.ClusterSpec(n_nodes=GEO_NODES, power_seed=i,
                              bandwidth=256.0)
    rate = load * float(cluster.resolve_powers().sum()) / EV_WORK_MEAN
    return lab.Scenario(
        name=f"dc{i}", cluster=cluster,
        workload=lab.WorkloadSpec(process="poisson", horizon=GEO_HORIZON,
                                  work_mean=EV_WORK_MEAN,
                                  params={"rate": rate}),
        policy=lab.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.05}),
        seed=i)


def phase_federation(dev, smi: str):
    """12c: the vectorized federation on the card, then the geo shape on
    the host event model."""
    fed = lab.Federation(
        name="fed-8x12.5k-isolated",
        members=tuple(scenario().replace(name=f"m{i}", seed=i)
                      for i in range(FED_MEMBERS)),
        topology=lab.TopologySpec(kind="isolated"))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = lab.run(fed, backend="federated", device=dev)
    torch.cuda.synchronize()
    fed_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    if r.backend != "federated" or \
            r.backend_options.get("model") != "fluid-batched":
        fail(f"federation: ran on {r.backend} {r.backend_options}")
    T = int(round(scenario().workload.horizon))
    if not (launches["prefix_scan"] == 1 + T
            and launches["dispatch_work_prefix"] == 1 + T):
        fail(f"federation: launch counts {launches}, expected {1 + T} of "
             f"the scan and dispatch kernels")
    t0 = time.perf_counter()
    sweep = lab.sweep(list(fed.members), backend="batched", device=dev)
    sweep_s = time.perf_counter() - t0
    if r.extras["members"] != [s.to_dict() for s in sweep]:
        fail("federation: members differ from a batched sweep of the same "
             "scenarios")
    for k in ("arrived", "completed"):
        if r[k] != sum(s[k] for s in sweep):
            fail(f"federation: aggregate {k} {r[k]} is not the members' sum")
    log(f"[federation] {FED_MEMBERS} x {N_NODES} nodes isolated: "
        f"fluid-batched, {r['arrived']} tasks, mean response "
        f"{r['mean_response']!r}; {fed_s!r} s (a batched sweep of the "
        f"members {sweep_s!r} s); launches {launches}")

    geo = lab.Federation(
        name="fed-geo-4x256",
        members=tuple(geo_member(i, x) for i, x in enumerate(GEO_LOADS)),
        topology=lab.TopologySpec(kind="full", bandwidth=8.0, latency=2.0),
        exchange_period=4.0)
    t0 = time.perf_counter()
    g = lab.run(geo, backend="federated", device=dev)
    geo_s = time.perf_counter() - t0
    if g.backend_options["model"] != "async-events":
        fail(f"federation: geo ran as {g.backend_options['model']}")
    if g["completed"] != g["arrived"]:
        fail(f"federation: geo completed {g['completed']} of {g['arrived']}")
    wan = g.extras["wan"]
    if not wan["migrations"] > 0:
        fail(f"federation: no WAN migrations ({wan})")
    iso = lab.run(geo.replace(topology=lab.TopologySpec(kind="isolated")),
                  backend="federated", vectorize=False)
    if not g["mean_response"] < iso["mean_response"]:
        fail(f"federation: geo mean response {g['mean_response']} not below "
             f"isolated {iso['mean_response']}")
    again = lab.run(geo, backend="federated", device=dev)
    if json.dumps(again.to_dict()) != json.dumps(g.to_dict()):
        fail("federation: a rerun of the geo federation differs")
    log(f"[federation] geo 4 x {GEO_NODES} nodes (loads {GEO_LOADS}): "
        f"{g['arrived']} tasks, mean response {g['mean_response']!r} vs "
        f"isolated {iso['mean_response']!r}; WAN {wan['migrations']} "
        f"migrations, {wan['moved_units']!r} units, {wan['rejected']} "
        f"rejected, {wan['epochs']} epochs; rerun equal; {geo_s!r} s per "
        f"run (host event model; {smi})")


def phase_dag(smi: str):
    """12d: a random-DAG workload on the host event engine."""
    base = events_scenario()
    cluster = lab.ClusterSpec(n_nodes=DAG_NODES, power_low=1, power_high=10,
                              power_seed=0)
    rate = EV_LOAD * float(cluster.resolve_powers().sum()) / EV_WORK_MEAN
    sc = base.replace(
        name="dag-256", cluster=cluster,
        workload=lab.WorkloadSpec(process="poisson", horizon=EV_HORIZON,
                                  work_mean=EV_WORK_MEAN,
                                  params={"rate": rate},
                                  dag={"kind": "random"}))
    reason = lab.get_backend("batched").eligible(sc)
    if reason != DAG_REASON:
        fail(f"dag: batched gave {reason!r}, expected {DAG_REASON!r}")
    t0 = time.perf_counter()
    r = lab.run(sc)
    run_s = time.perf_counter() - t0
    if r["completed"] != r["arrived"]:
        fail(f"dag: completed {r['completed']} of {r['arrived']}")
    census = r.extras["work_census"]
    tol = 1e-9 * max(census["admitted"], 1.0)
    if not (census["in_flight"] == 0.0
            and abs(census["conservation_gap"]) <= tol
            and abs(census["completed"] - census["admitted"]) <= tol):
        fail(f"dag: the work census does not close: {census}")
    dag = sc.workload.materialize(sc.seed).dag
    log(f"[dag] {DAG_NODES} nodes, random DAG: {r['arrived']} tasks, "
        f"{dag.k} edges, depth {dag.depth()}; makespan {r['makespan']!r}, "
        f"cp_stretch {r['cp_stretch']!r}, mean response "
        f"{r['mean_response']!r}; census {census}; {run_s!r} s (host "
        f"engine; {smi})")


def cli(*argv) -> None:
    """``python -m repro_torch.lab *argv``, in this process."""
    rc = lab_cli.main([str(a) for a in argv])
    if rc != 0:
        fail(f"cli {' '.join(map(str, argv))}: exit code {rc}")


def phase_cli_sweep(smi: str):
    """13a: the CLI's sweep on the card, against a direct lab.sweep."""
    sc_file = CLI_DIR / "clusterdata-12.5k.json"
    sc_file.write_text(scenario().to_json())
    out = CLI_DIR / "sweep.json"
    calls = []
    engine = lab_backends.simulate_batch

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm = engine(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
        return bm

    ops.reset_launch_counts()
    lab_backends.simulate_batch = timed
    try:
        t0 = time.perf_counter()
        cli("sweep", sc_file, "--grid", f"seed=0:{CLI_SEEDS}", "--out", out)
        wall = time.perf_counter() - t0
    finally:
        lab_backends.simulate_batch = engine
    launches = ops.launch_counts()
    T = int(round(scenario().workload.horizon))
    # the serving and sweep paths launch no backward kernel
    want = {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "mamba_scan_bwd": 0,
            "prefix_scan": 1 + T, "dispatch_work_prefix": 1 + T,
            "dispatch_positions": 0, "flash_attention": 0,
            "flash_attention_tc": 0, "mamba_scan": 0}
    if launches != want:
        fail(f"cli sweep: launch counts {launches}, expected {want}")
    got = json.loads(out.read_text())
    if [r["backend"] for r in got] != ["batched"] * CLI_SEEDS:
        fail(f"cli sweep: ran on {[r['backend'] for r in got]}")
    if len(calls) != 1:
        fail(f"cli sweep: {len(calls)} engine calls, expected one")
    t0 = time.perf_counter()
    direct = lab.sweep(base=scenario(), grid={"seed": range(CLI_SEEDS)})
    direct_s = time.perf_counter() - t0
    want_json = json.dumps([r.to_dict() for r in direct], indent=2,
                           sort_keys=True, allow_nan=False)
    if json.dumps(got, indent=2, sort_keys=True) != want_json:
        fail("cli sweep: the results differ from a direct lab.sweep")
    tasks = sum(r["metrics"]["completed"] for r in got)
    log(f"[cli] sweep of {CLI_SEEDS} seeds x {N_NODES} nodes on batched: "
        f"{tasks} tasks, every metric equal to the bit to a direct lab.sweep "
        f"({direct_s!r} s); CLI wall {wall!r} s, of it the engine call "
        f"{calls[0]!r} s; launches {launches} ({smi})")
    return launches


def phase_cli_online(ev0, smi: str):
    """13b: run --backend online on phase 11's scenario, seed 0."""
    sc_file = CLI_DIR / "events-1024.json"
    sc_file.write_text(events_scenario().to_json())
    out = CLI_DIR / "online.json"
    t0 = time.perf_counter()
    cli("run", sc_file, "--backend", "online", "--out", out)
    run_s = time.perf_counter() - t0
    [got] = json.loads(out.read_text())
    if got["backend"] != "online":
        fail(f"cli online: ran on {got['backend']}")
    if json.dumps(got["metrics"], sort_keys=True) != json.dumps(
            ev0.to_dict()["metrics"], sort_keys=True):
        fail("cli online: the metrics differ from phase 11's events run")
    opts = got["backend_options"]
    tasks = got["metrics"]["arrived"]
    log(f"[cli] run --backend online, {EV_NODES} nodes, seed 0: {tasks} "
        f"tasks in {opts['micro_steps']} micro-steps, metrics "
        f"byte-identical to events; {run_s!r} s per run, "
        f"{run_s / tasks * 1e6!r} us per task (host service); decisions "
        f"{opts['decisions']} = {sum(opts['decisions'].values())} ({smi})")


def phase_cli_serve(smi: str):
    """13c: serve with a feed, the decision and metrics streams, and a
    scrape of the live endpoint."""
    sc = events_scenario().replace(name="serve-1024").updated(
        {"workload.horizon": SERVE_HORIZON})
    sc_file = CLI_DIR / "serve-1024.json"
    sc_file.write_text(sc.to_json())
    rng = np.random.default_rng(0)
    feed = CLI_DIR / "feed.jsonl"
    times = np.sort(rng.uniform(0.0, SERVE_HORIZON, SERVE_FEED))
    feed.write_text("".join(
        json.dumps({"t": float(t), "work": float(w), "packets": 1.0}) + "\n"
        for t, w in zip(times, rng.exponential(EV_WORK_MEAN, SERVE_FEED))))
    dec, mx, out = (CLI_DIR / n for n in ("decisions.jsonl",
                                          "metrics.jsonl", "serve.json"))
    # one scrape of the endpoint while the service still runs: taken as
    # the CLI closes it, after the run's last event
    scrapes = []
    server_cls = obs_mod.MetricsHTTPServer

    class Scraped(server_cls):
        def close(self):
            scrapes.append(urllib.request.urlopen(self.url).read().decode())
            super().close()

    obs_mod.MetricsHTTPServer = Scraped
    try:
        t0 = time.perf_counter()
        cli("serve", sc_file, "--feed", feed, "--decisions-out", dec,
            "--metrics-out", mx, "--metrics-every", "5", "--metrics-port",
            "0", "--out", out)
        serve_s = time.perf_counter() - t0
    finally:
        obs_mod.MetricsHTTPServer = server_cls
    payload = json.loads(out.read_text())
    m = payload["metrics"]
    n_sc = sc.workload.materialize(sc.seed).m
    if not m["completed"] == m["arrived"] == n_sc + SERVE_FEED:
        fail(f"cli serve: completed {m['completed']}, arrived "
             f"{m['arrived']}, expected {n_sc} + {SERVE_FEED}")
    lines = dec.read_text().splitlines()
    kinds = [json.loads(ln)["kind"] for ln in lines]
    if len(kinds) != sum(payload["decisions"].values()):
        fail(f"cli serve: {len(kinds)} decision lines, counts "
             f"{payload['decisions']}")
    rows = [json.loads(ln) for ln in mx.read_text().splitlines()]
    done = [r["metrics"]["sched_tasks_completed_total"]["samples"][""]
            for r in rows]
    if not (len(rows) >= 2 and done == sorted(done)
            and done[-1] == m["completed"]):
        fail(f"cli serve: the metrics stream's completions {done}")
    if len(scrapes) != 1:
        fail(f"cli serve: {len(scrapes)} endpoint scrapes")
    fams = parse_openmetrics(scrapes[0])
    if fams["sched_completed"]["samples"][0][2] != m["completed"]:
        fail("cli serve: the endpoint's scrape disagrees with the summary")
    log(f"[cli] serve {EV_NODES} nodes, horizon {SERVE_HORIZON}: {n_sc} + "
        f"{SERVE_FEED} fed tasks completed, {len(kinds)} decision lines "
        f"({payload['decisions']}), {len(rows)} metrics samples, scrape of "
        f"{len(fams)} families parses; {serve_s!r} s (host service; {smi})")


def phase_cli_presets(smi: str):
    """13d: the CLI's federation presets, written and run."""
    for preset in ("geo-federation", "planet-federation"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli("template", "--preset", preset)
        f = CLI_DIR / f"{preset}.json"
        f.write_text(buf.getvalue())
        out = CLI_DIR / f"{preset}.out.json"
        t0 = time.perf_counter()
        cli("run", f, "--out", out)
        run_s = time.perf_counter() - t0
        [r] = json.loads(out.read_text())
        m, wan = r["metrics"], r["extras"]["wan"]
        if r["backend"] != "federated":
            fail(f"cli {preset}: ran on {r['backend']}")
        if m["completed"] != m["arrived"]:
            fail(f"cli {preset}: completed {m['completed']} of "
                 f"{m['arrived']}")
        if not wan["migrations"] > 0:
            fail(f"cli {preset}: no WAN migrations ({wan})")
        log(f"[cli] {preset}: federated ({r['backend_options']['model']}), "
            f"{m['arrived']} tasks, mean response {m['mean_response']!r}, "
            f"WAN {wan['migrations']} migrations; {run_s!r} s ({smi})")


def phase_cli(ev0, smi: str):
    """13: the lab CLI and the scheduler service."""
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    launches = phase_cli_sweep(smi)
    phase_cli_online(ev0, smi)
    phase_cli_serve(smi)
    phase_cli_presets(smi)
    return launches

# ---------------------------------------------------------------------------
# phase 14: training — the backward kernels, granite-train, falcon-train,
# card against CPU gradients, restart through the CLI
# ---------------------------------------------------------------------------

TRAIN_SHARDS = 2        # 14b: Pipeline of 2 shards x 2 rows x 2048 tokens
TRAIN_ROWS = 2
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_LR = 3e-3         # launch.train's optimizer and schedule
TRAIN_WARMUP = 20
FALCON_TRAIN_LAYERS = 2  # 14c: falcon-mamba-7b's 64 layers do not fit
FALCON_TRAIN_STEPS = 4
GRAD_LAYERS = 2         # 14d
GRAD_ROWS = 2
GRAD_SEQ = 512
GRAD_TOL = 1e-3         # x each leaf's max|g|, card vs CPU
LOSS_RTOL = 1e-5
RESTART_LAYERS = 2      # 14e: a ~2 GB checkpoint
RESTART_STEPS = 4
RESTART_EVERY = 2
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
# backward kernels against their plain versions (PERF.md section 2): bf16
# per gradient row ||got - want|| / ||want|| over hd, on the rows whose norm
# is at least 1e-3 of the largest (a query that sees one key has dq = 0),
# and per element (rtol and atol); float32 x each gradient's max|.|
BWD_BF16_ROW_TOL = 3e-2
BWD_BF16_TOL = 6e-2
BWD_F32_TOL = 1e-4
SCAN_BWD_TOL = 1e-5


def check_bwd_tile_plan():
    """The backward kernels' tiles (``flash_bwd_tiles``) against
    ``flash_attention.bwd_tiles``, and their walks (make_plan for dQ,
    key_walk for dK/dV, on the host) against ``tile_plan``'s index form and
    ``bwd_key_plan``, for both types and every padded head width, over a
    grid of shapes."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (64, 128, 256):
            tiles = flash.cuda_bwd_tiles(dtype, hd)
            bq, bk = flash.bwd_tiles(dtype, hd)
            if tiles != (bq, bk):
                fail(f"flash backward tiles at {dtype} hd {hd}: {tiles}, "
                     f"not {(bq, bk)}")
            log(f"[train-kernels] flash backward {str(dtype)[6:]} hd {hd}: "
                f"tiles {tiles}")
            for s in (1, 63, 64, 65, 129, 700, 2048):
                for causal in (True, False):
                    for window in (None, 1, 16, 64, 100, 300):
                        case = (bq, bk, s, causal, window)
                        for q0 in range(0, s, bq):
                            got = flash.cuda_bwd_tile_plan(q0, *case)
                            want = flash.tile_plan(q0, bq, bk, s, s, causal,
                                                   window)
                            if got != want:
                                fail(f"flash backward dQ walk differs at "
                                     f"{(q0, *case)}: {got} != {want}")
                            n += 1
                        for k0 in range(0, s, bk):
                            got = flash.cuda_bwd_key_plan(k0, *case)
                            want = flash.bwd_key_plan(k0, *case)
                            if got != want:
                                fail(f"flash backward dK/dV walk differs at "
                                     f"{(k0, *case)}: {got} != {want}")
                            n += 1
    log(f"[train-kernels] flash backward walks: tile_plan's and "
        f"bwd_key_plan's tiles for all {n} query and key tiles of the grid")


def flash_bwd_check(label, b, h, kv, s, hd, dtype, g, dev, **kw):
    """dq, dk, dv through ``ops.flash_attention``'s autograd (one backward
    launch) against ``ref.flash_attention_bwd_ref``. Returns max|err|, the
    worst row's relative error and the inputs."""
    q, do = (torch.randn(b, h, s, hd, generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, kv, s, hd, generator=g).to(dev, dtype)
            for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()
    got = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, do)
    after = ops.launch_counts()
    tc = after["flash_attention_bwd_tc"] - before["flash_attention_bwd_tc"]
    if (after["flash_attention_bwd"] - before["flash_attention_bwd"],
            tc) != (1, int(dtype == torch.bfloat16)):
        fail(f"flash backward {label}: not one backward call, or {tc} on "
             f"the tensor cores for {dtype}")
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    torch.cuda.synchronize()
    worst, worst_row = 0.0, 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        if a.dtype != dtype or a.shape != w.shape:
            fail(f"flash backward {label}: {name} is {a.dtype} "
                 f"{tuple(a.shape)}")
        a, w = a.float(), w.float()
        err = (a - w).abs()
        worst = max(worst, err.max().item())
        if dtype == torch.bfloat16:
            norms = w.norm(dim=-1)
            rows = (norms > 0) & (norms >= 1e-3 * norms.max())
            row = (((a - w).norm(dim=-1)[rows] / norms[rows]).max().item()
                   if rows.any() else 0.0)
            worst_row = max(worst_row, row)
            if not bool((err <= BWD_BF16_TOL + BWD_BF16_TOL * w.abs()).all()):
                fail(f"flash backward {label}: {name} beyond "
                     f"{BWD_BF16_TOL} (rtol and atol)")
            if not row <= BWD_BF16_ROW_TOL:
                fail(f"flash backward {label}: {name} row error {row:.3e}")
        elif not err.max().item() <= BWD_F32_TOL * w.abs().max().item():
            fail(f"flash backward {label}: {name} error "
                 f"{err.max().item():.3e} beyond {BWD_F32_TOL} x max")
    log(f"[train-kernels] flash_attention_bwd {label} {(b, h, kv, s, hd)} "
        f"{str(dtype)[6:]} {kw or ''}: max|err|={worst:.3e}"
        + (f", worst row's relative L2 error {worst_row:.3e}"
           if dtype == torch.bfloat16 else ""))
    return worst, worst_row, (q, k, v, do)


def phase_kernels_bwd(dev, smi: str):
    """14a: both backward kernels against their plain versions on the card,
    at the training path's shapes and at edges; times, bounds and SDPA's
    backward. Returns their kernel records (launches filled in later)."""
    g = torch.Generator().manual_seed(14)
    bf16, f32 = torch.bfloat16, torch.float32
    check_bwd_tile_plan()
    worst, worst_row, (q, k, v, do) = flash_bwd_check(
        "granite train", 4, 16, 8, 2048, 64, bf16, g, dev)
    for label, shape, dtype, extra in [
            ("window 16", (2, 4, 2, 300, 64), f32, {"window": 16}),
            ("soft-cap 30", (2, 4, 2, 300, 64), f32, {"softcap": 30.0}),
            ("olmo hd 128", (1, 4, 4, 200, 128), f32, {}),
            ("hd 256 window", (1, 4, 2, 200, 256), f32, {"window": 50}),
            ("S=1", (2, 4, 2, 1, 64), bf16, {}),
            ("S=65", (2, 16, 8, 65, 64), bf16, {}),
            ("window 16", (2, 4, 2, 300, 64), bf16, {"window": 16}),
            ("soft-cap 30", (2, 4, 2, 200, 64), bf16, {"softcap": 30.0}),
            ("non-causal", (2, 4, 2, 150, 64), bf16, {"causal": False}),
            ("hd 32", (1, 4, 1, 70, 32), bf16, {}),
            ("window+soft-cap hd 128", (1, 8, 4, 300, 128), bf16,
             {"window": 100, "softcap": 30.0}),
            ("hd 256 window", (1, 4, 2, 200, 256), bf16, {"window": 50}),
            ("hd 256 non-causal", (1, 4, 2, 129, 256), bf16,
             {"causal": False}),
            # a rank's heads in 15c: (c) bf16 training, (a) float32
            ("15c(c) split heads", (4, 8, 4, 2048, 64), bf16, {}),
            ("15c(a) split heads f32", (2, 8, 4, 512, 64), f32, {})]:
        flash_bwd_check(label, *shape, dtype, g, dev, **extra)
    _, lse = flash.flash_attention_cuda(q, k, v, return_lse=True)
    first = flash.flash_attention_bwd_cuda(q, k, v, do, lse)
    again = flash.flash_attention_bwd_cuda(q, k, v, do, lse)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail("flash_attention_bwd: two calls on the same inputs differ")
    ms = time_ms(lambda: flash.flash_attention_bwd_cuda(q, k, v, do, lse),
                 20)
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, do), 3)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qs, ks, vs), do,
                                                 retain_graph=True), 10)
    fwd_ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v,
                                                        return_lse=True), 10)
    f32_shape = (1, 4, 4, 200, 128)   # olmo-1b's float32 case (14d's path)
    qf, dof = (torch.randn(*f32_shape[:2], *f32_shape[3:], generator=g).to(
        dev) for _ in range(2))
    kf, vf = (torch.randn(f32_shape[0], *f32_shape[2:], generator=g).to(dev)
              for _ in range(2))
    _, lsef = flash.flash_attention_cuda(qf, kf, vf, return_lse=True)
    f32_ms = time_ms(
        lambda: flash.flash_attention_bwd_cuda(qf, kf, vf, dof, lsef), 20)
    f32_plain = time_ms(lambda: ref.flash_attention_bwd_ref(qf, kf, vf, dof),
                        10)
    del qf, dof, kf, vf, lsef
    b, h, s, hd = q.shape
    pairs = b * h * s * (s + 1) // 2
    # read q, k, v, dO and the LSE once, write dq, dk, dv: 5 products of
    # 2 hd flops per visible pair (S, dP, dV, dK, dQ)
    n_bytes = 2 * (3 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    bound, by = bound_ms(n_bytes, 10 * hd * pairs, BF16_OPS_PER_S)
    flash_bwd = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:97", max_abs_err=worst,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=lib_ms, shape=[b, h, k.shape[1], s, hd],
        worst_row_err=worst_row, forward_with_lse_ms=fwd_ms,
        design="bf16: mma.sync m16n8k16 (ldmatrix, cp.async ring), dQ "
               "(two walks: D = sum P dP, then dQ) then dK/dV per key tile, "
               "GQA heads in order, no atomics; float32: FMA kernels",
        f32_shape=list(f32_shape), f32_ms=f32_ms, f32_plain_ms=f32_plain)
    del q, k, v, do, lse, qs, ks, vs, o, first, again

    # -- mamba_scan_bwd at falcon-train's shape, and edges
    gd = torch.Generator(device=dev).manual_seed(14)
    for shape, dtype in [((2, 37, 3, 36), f32), ((1, 100, 2, 64), bf16),
                         ((1, 5, 2, 7), f32),
                         ((2, 512, 16, 4096), f32)]:   # 15c(b)'s rank
        da = torch.rand(shape, generator=gd, device=dev).to(dtype)
        dbx = torch.randn(shape, generator=gd, device=dev).to(dtype)
        go = torch.randn(shape, generator=gd, device=dev)
        leaves = [da.clone().requires_grad_(True),
                  dbx.clone().requires_grad_(True)]
        before = ops.launch_counts()["mamba_scan_bwd"]
        h = ops.mamba_scan(*leaves)
        got = torch.autograd.grad(h, leaves, go)
        if ops.launch_counts()["mamba_scan_bwd"] != before + 1:
            fail(f"mamba_scan_bwd {shape}: not one backward launch")
        want = ref.mamba_scan_bwd_ref(da, h.detach(), go)
        for a, w in zip(got, want):
            w = w.to(dtype).float()
            if not (a.float() - w).abs().max().item() <= \
                    SCAN_BWD_TOL * w.abs().max().item():
                fail(f"mamba_scan_bwd {shape} {dtype}: beyond {SCAN_BWD_TOL}")
    shape = (1, TRAIN_SEQ, 16, 8192)
    da = torch.rand(shape, generator=gd, device=dev)
    dbx = torch.randn(shape, generator=gd, device=dev)
    go = torch.randn(shape, generator=gd, device=dev)
    h = ops.mamba_scan(da, dbx)
    got = mamba_kernel.mamba_scan_bwd_cuda(da, h, go)
    want = ref.mamba_scan_bwd_ref(da, h, go)
    torch.cuda.synchronize()
    scan_err = 0.0
    for a, w in zip(got, want):
        err = (a - w).abs().max().item()
        scan_err = max(scan_err, err)
        if not err <= SCAN_BWD_TOL * w.abs().max().item():
            fail(f"mamba_scan_bwd {shape}: error {err:.3e} beyond "
                 f"{SCAN_BWD_TOL} x max")
    del got, want
    scan_ms = time_ms(lambda: mamba_kernel.mamba_scan_bwd_cuda(da, h, go), 10)
    scan_plain = time_ms(lambda: ref.mamba_scan_bwd_ref(da, h, go), 1)
    n = da.numel()
    s_bound, s_by = bound_ms(20 * n, 3 * n, FP32_OPS_PER_S)
    log(f"[train-kernels] mamba_scan_bwd {shape} f32: max|err|="
        f"{scan_err:.3e} (edges: S=37 di=36, bf16 inputs, di=7, and 15c(b)'s "
        f"rank (2, 512, 16, 4096) all within {SCAN_BWD_TOL} x max)")
    scan_bwd = dict(
        name="mamba_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces="src/repro/models/ssm.py:94", max_abs_err=scan_err,
        ms=scan_ms, plain_ms=scan_plain, bound_ms=s_bound, bound_by=s_by,
        library_ms=None, shape=list(shape))
    for rec in (flash_bwd, scan_bwd):
        log(f"[train-kernels] {rec['name']} at {rec['shape']}: "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}) = {100 * rec['bound_ms'] / rec['ms']:.1f}%"
            f" of the bound ({smi})")
    log(f"[train-kernels] flash forward with LSE at the same shape "
        f"{fwd_ms:.4f} ms; SDPA's backward {lib_ms:.4f} ms; the float32 "
        f"backward at {list(f32_shape)} {f32_ms:.4f} ms, plain "
        f"{f32_plain:.4f} ms ({smi})")
    return [flash_bwd, scan_bwd]


def run_train(tag, cfg, dev, smi, *, shards, rows, steps, expected,
              materialize=True):
    """Train ``cfg`` on the card through ``repro_torch.train.train`` with
    launch.train's optimizer and schedule (remat on, the config's policy).
    The launch counters are zeroed just before each step and read just
    after (the loop's metrics hook), and must equal ``expected`` (zeros for
    the kernels it leaves out). Returns (lm, state, pipeline, history,
    per-step launch counts). ``materialize=False`` builds the LM on meta
    (the loop draws it)."""
    lm = LM(cfg, device=dev, materialize=materialize)
    monitor = StragglerMonitor(n_hosts=shards)
    stream = DocStream(vocab_size=cfg.vocab_size, mean_len=TRAIN_SEQ // 2,
                       max_len=TRAIN_SEQ, seed=0)
    pipe = Pipeline(stream, shard_dims=(shards,), rows_per_shard=rows,
                    seq_len=TRAIN_SEQ, monitor=monitor)
    opt = AdamW(moments_dtype=dtype_of(cfg.moments_dtype))
    per_step = []

    def hook(step, row):
        per_step.append(ops.launch_counts())
        ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train(lm, opt, warmup_cosine(TRAIN_LR, TRAIN_WARMUP, steps),
                        pipe, LoopConfig(steps=steps, seed=0, log_every=1,
                                         metrics_hook=hook), monitor=monitor)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if len(hist) != steps or len(per_step) != steps:
        fail(f"{tag}: {len(hist)} steps recorded of {steps}")
    for row, counts in zip(hist, per_step):
        if not (math.isfinite(row["loss"]) and math.isfinite(
                row["grad_norm"])):
            fail(f"{tag} step {row['step']}: loss {row['loss']}, grad norm "
                 f"{row['grad_norm']}")
        want = {name: expected.get(name, 0) for name in counts}
        if counts != want:
            fail(f"{tag} step {row['step']}: launches {counts}, expected "
                 f"{want}")
    tokens = shards * rows * TRAIN_SEQ
    dts = [row["dt"] for row in hist]
    steady = dts[1:] or dts
    mean_dt = sum(steady) / len(steady)
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, {shards}x{rows}x{TRAIN_SEQ} "
        f"tokens a step, remat {cfg.remat_policy}: losses "
        f"{[round(r['loss'], 4) for r in hist]}, grad norms "
        f"{[round(r['grad_norm'], 3) for r in hist]}")
    log(f"[{tag}] step time {mean_dt * 1e3:.1f} ms (mean of steps 1-"
        f"{steps - 1}; step 0 {dts[0] * 1e3:.1f} ms), {tokens / mean_dt:.0f} "
        f"tokens/s, peak memory {peak / 1e9:.2f} GB, {wall:.1f}s for "
        f"{steps} steps; launches a step {per_step[-1]} ({smi})")
    return lm, state, opt, pipe, hist, per_step


def phase_granite_train(dev, smi: str):
    """14b: granite-moe-1b-a400m at full width and depth trained 8 steps;
    the mean of the last 3 losses below the first; one more step under
    torch.profiler for the device's busy share."""
    cfg = get_config(ARCH)
    n = cfg.n_layers
    lm, state, opt, pipe, hist, per_step = run_train(
        "granite-train", cfg, dev, smi, shards=TRAIN_SHARDS, rows=TRAIN_ROWS,
        steps=TRAIN_STEPS,
        expected={"flash_attention": 2 * n, "flash_attention_tc": 2 * n,
                  "flash_attention_bwd": n, "flash_attention_bwd_tc": n,
                  "dispatch_positions": 2 * n})
    first = hist[0]["loss"]
    last = sum(r["loss"] for r in hist[-3:]) / 3
    if not last < first:
        fail(f"granite-train: the last 3 losses' mean {last:.4f} is not "
             f"below the first {first:.4f}")
    step_fn = make_train_step(lm, opt, warmup_cosine(
        TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS), remat=True)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch(TRAIN_STEPS)[0].items()}

    def one_step():
        step_fn(state, batch)[1]["loss"].item()
    one_step()
    t0 = time.perf_counter()
    one_step()
    wall = time.perf_counter() - t0
    busy = device_time_table(one_step, wall, "granite-train-profile",
                             watch=("flash_bwd_dq_tc", "flash_bwd_dkdv_tc",
                                    "flash_fwd", "positions_levels",
                                    "indexing_backward"))
    if busy is None:
        fail("granite-train: the profiled step recorded no device time")
    log(f"[granite-train] one step {wall * 1e3:.1f} ms, device busy "
        f"{100 * busy:.1f}% of it; the last 3 losses' mean {last:.4f} < the "
        f"first {first:.4f}")
    del lm, state, opt, step_fn
    return {name: sum(c[name] for c in per_step) for name in per_step[0]}


def phase_falcon_train(dev, smi: str):
    """14c: falcon-mamba-7b at full width, depth cut to 2 layers, trained 4
    steps on one row of 2048 tokens: finite losses, the scan's forward and
    backward launches."""
    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              n_layers=FALCON_TRAIN_LAYERS)
    n = cfg.n_layers
    *_, per_step = run_train(
        "falcon-train", cfg, dev, smi, shards=1, rows=1,
        steps=FALCON_TRAIN_STEPS,
        expected={"mamba_scan": 2 * n, "mamba_scan_bwd": n})
    return {name: sum(c[name] for c in per_step) for name in per_step[0]}


def loss_grads(lm, batch):
    loss, _ = lm.loss(batch)
    names, tensors = zip(*lm.named_parameters())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return loss.detach(), {n: (torch.zeros_like(t) if g is None else g)
                           for n, t, g in zip(names, tensors, grads)}


def card_and_host(cfg, dev):
    card = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    host = LM(cfg, device="cpu")
    host.load_state_dict({n: t.cpu() for n, t in card.state_dict().items()})
    return card.requires_grad_(True), host.requires_grad_(True)


def grads_close(tag, lc, gc, lh, gh):
    """Loss within LOSS_RTOL, each gradient within GRAD_TOL x its leaf's
    max|g|; returns the worst leaf's error over its max."""
    if not abs(lc.item() - lh.item()) <= LOSS_RTOL * abs(lh.item()):
        fail(f"{tag}: loss {lc.item()} on the card, {lh.item()} on the CPU")
    worst = 0.0
    for name, w in gh.items():
        err = (gc[name].cpu() - w).abs().max().item()
        scale = w.abs().max().item()
        if not err <= GRAD_TOL * scale:
            fail(f"{tag}: {name} gradient differs by {err:.3e}, max|g| "
                 f"{scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def routing_tie(tag, on_a, on_b, k):
    """None where two runs' dispatches (``(logits, DispatchResult)`` each,
    in order) routed alike; else the gap of the near tie (below 1e-4, as
    phase 6) at which a top-k choice flipped. Fails on any other
    difference."""
    for (rl, rc), (hl, rh) in zip(on_a, on_b):
        if all(torch.equal(getattr(rc, f).cpu(), getattr(rh, f).cpu())
               for f in ("expert_idx", "slot_idx", "keep")):
            continue
        top = torch.topk(hl.cpu(), k + 1, dim=-1)
        gaps = (top.values[..., :-1] - top.values[..., 1:]).min(-1).values
        flipped = (torch.topk(rl.cpu(), k, dim=-1).indices
                   != top.indices[..., :k]).any(-1)
        if not flipped.any():
            fail(f"{tag}: routing differs with the same top-k choices")
        tie = gaps[flipped].max().item()
        if not tie < 1e-4:
            fail(f"{tag}: top-k differs at a gap of {tie:.3e}, not a near "
                 f"tie")
        return tie
    return None


def phase_train_vs_plain(dev):
    """14d: the gradients on the card against the CPU's (plain versions),
    float32, the same weights: olmo-1b at full width (d 2048, hd 128) with
    2 layers, B 2 x S 512; then granite-moe-1b-a400m's 2 layers, one
    sequence (one routing group) at a time, compared when both devices
    route it alike; a sequence whose top-k differs at a near tie (gap below
    1e-4, as phase 6) is reported and left out."""
    rng = np.random.default_rng(5)
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=GRAD_LAYERS,
                              dtype="float32")
    card, host = card_and_host(cfg, dev)
    tokens = rng.integers(0, cfg.vocab_size, (GRAD_ROWS, GRAD_SEQ)).astype(
        np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    ops.reset_launch_counts()
    lc, gc = loss_grads(card, batch)
    counts = ops.launch_counts()
    if (counts["flash_attention"], counts["flash_attention_bwd"],
            counts["flash_attention_tc"],
            counts["flash_attention_bwd_tc"]) != (GRAD_LAYERS, GRAD_LAYERS,
                                                  0, 0):
        fail(f"olmo grads: launches {counts}")
    lh, gh = loss_grads(host, batch)
    worst = grads_close("olmo grads", lc, gc, lh, gh)
    log(f"[train-vs-plain] olmo-1b x {GRAD_LAYERS} layers f32 "
        f"({GRAD_ROWS}x{GRAD_SEQ}): loss {lc.item():.6f} vs {lh.item():.6f},"
        f" every gradient within {worst:.3e} x its max|g| (bound {GRAD_TOL})")
    del card, host, gc, gh

    cfg = dataclasses.replace(get_config(ARCH), n_layers=GRAD_LAYERS,
                              dtype="float32")
    card, host = card_and_host(cfg, dev)
    k = cfg.experts_per_token
    calls = []
    plain_dispatch = moe_mod.dispatch_grouped

    def recording(logits, **kw):
        res = plain_dispatch(logits, **kw)
        calls.append((logits.detach(), res))
        return res
    compared = 0
    moe_mod.dispatch_grouped = recording
    try:
        for row in range(4):
            toks = rng.integers(0, cfg.vocab_size, (1, GRAD_SEQ)).astype(
                np.int32)
            one = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
            calls.clear()
            lc, gc = loss_grads(card, one)
            on_card = list(calls)
            calls.clear()
            lh, gh = loss_grads(host, one)
            on_host = list(calls)
            tie = routing_tie(f"granite grads row {row}", on_card, on_host,
                              k)
            if tie is not None:
                log(f"[train-vs-plain] granite row {row}: top-k decided by a "
                    f"near tie (gap {tie:.2e}); left out")
                continue
            worst = grads_close(f"granite grads row {row}", lc, gc, lh, gh)
            compared += 1
            log(f"[train-vs-plain] granite x {GRAD_LAYERS} layers f32 row "
                f"{row} (1x{GRAD_SEQ}), routed alike: loss {lc.item():.6f} "
                f"vs {lh.item():.6f}, gradients within {worst:.3e} x max|g|")
    finally:
        moe_mod.dispatch_grouped = plain_dispatch
    if not compared:
        fail("granite grads: every row diverged at a near tie")


def phase_restart(smi: str):
    """14e: ``python -m repro_torch.launch.train``'s ``main`` in-process,
    granite-moe-1b-a400m at full width cut to 2 layers: 4 steps with
    checkpoints every 2, then again after the step-4 checkpoint is removed,
    which resumes from step 2; the resumed losses must equal the
    uninterrupted run's."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    ckpt = TRAIN_DIR / "ckpt"
    argv = ["--arch", ARCH, "--layers", str(RESTART_LAYERS), "--steps",
            str(RESTART_STEPS), "--ckpt-every", str(RESTART_EVERY),
            "--ckpt-dir", str(ckpt), "--rows", str(TRAIN_ROWS), "--shards",
            str(TRAIN_SHARDS), "--seq-len", str(TRAIN_SEQ), "--log-every",
            "1"]

    def run():
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            hist = launch_train.main(argv)
        record = json.loads(out.getvalue().strip().splitlines()[-1])
        return hist, record, time.perf_counter() - t0
    h1, r1, s1 = run()
    if sorted(r1) != ["final_loss", "final_step", "first_loss"] or \
            r1["final_step"] != RESTART_STEPS:
        fail(f"restart: the CLI printed {r1}")
    saved = sorted(d.name for d in ckpt.iterdir())
    size = sum(f.stat().st_size for f in (ckpt / saved[-1]).iterdir())
    shutil.rmtree(ckpt / f"step_{RESTART_STEPS:010d}")
    h2, r2, s2 = run()
    if [r["step"] for r in h2] != list(range(RESTART_EVERY, RESTART_STEPS)):
        fail(f"restart: resumed at steps {[r['step'] for r in h2]}")
    want = [r["loss"] for r in h1[RESTART_EVERY:]]
    got = [r["loss"] for r in h2]
    if got == want:
        verdict = "equal bit for bit"
    else:
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if not rel <= 1e-6:
            fail(f"restart: resumed losses {got} != {want}")
        verdict = f"NOT bit-identical, within {rel:.3e} relative"
    log(f"[restart] {ARCH} x {RESTART_LAYERS} layers through the CLI: "
        f"checkpoints {saved} ({size / 1e9:.2f} GB each), run {s1:.1f}s, "
        f"resumed from step {RESTART_EVERY} in {s2:.1f}s; resumed losses "
        f"{got} vs {want}: {verdict} ({smi})")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 15: the distributed layer — a (1, 1) mesh on the card, the dry run
# ---------------------------------------------------------------------------

MESH_STEPS = 3          # 15a
MESH_CHILD = "--mesh-child"
TP_CHILD = "--tp-child"  # 15c: two gloo ranks on the (1, 2) mesh
TP_RANKS = 2
TP_TRIES = 3            # 15c(a): batches tried past near ties
# 15c(c) against 15a's (1, 1) run, each step: bf16 gives losses 4.4e-5
# and gradient norms 1% apart (H100 SXM), while a loss moves 1e-3 over the
# 3 steps and a gradient summed wrongly over model moves its norm by more
TP_LOSS_RTOL = 2e-4
TP_GNORM_RTOL = 3e-2
TP_TIMEOUT = 420
TP_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_tp"
MESH_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh.json"
# 15a's mesh run's MoE routing, which 17(c) replays
MESH_ROUTES = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_mesh_routes.pt"
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dryrun"


def _digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (on the host)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def mesh_child(side: str, out: str, smi: str) -> int:
    """15a, one side in a process of its own, so that each run's peak
    memory counts its own tensors alone: granite at full width and depth
    trained MESH_STEPS steps through ``run_train`` (14b's data, optimizer
    and schedule; launches checked a step). ``side`` "plain": no mesh.
    ``side`` "mesh": an NCCL world of 1 rank on the card (its address
    tcp://localhost at a free port), the (1, 1) ("data", "model") mesh of
    ``elastic_mesh(1, model_parallel=1)``, the axis scan over its size-1
    axis, and the run under ``set_mesh`` and the mesh's activation rules,
    as ``launch.train`` trains, its LM built on meta
    (``materialize=False``) and drawn one leaf at a time. Writes the
    losses, the launches a step, the memory before and at the peak and
    every parameter's sha256 to ``out`` as JSON; the mesh side also its
    MoE routing (``compact_routes``) to MESH_ROUTES, for 17(c)."""
    import socket

    import torch.distributed as dist

    from repro_torch.core import axis_exclusive_scan
    from repro_torch.launch.mesh import elastic_mesh, set_mesh
    from repro_torch.launch.shardings import activation_rules
    from repro_torch.models.common import logical_axis_rules
    from repro_torch.models.distributed import to_local

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)
    n = cfg.n_layers
    expected = {"flash_attention": 2 * n, "flash_attention_tc": 2 * n,
                "flash_attention_bwd": n, "flash_attention_bwd_tc": n,
                "dispatch_positions": 2 * n}
    res = {"side": side}
    with contextlib.ExitStack() as stack:
        if side == "mesh":
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            t0 = time.perf_counter()
            dist.init_process_group(
                "nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                rank=0, device_id=dev)
            stack.callback(dist.destroy_process_group)
            res["init_s"] = time.perf_counter() - t0
            res["backend"] = dist.get_backend()
            mesh = elastic_mesh(1, model_parallel=1)
            res["mesh_shape"] = [list(mesh.shape),
                                 list(mesh.mesh_dim_names)]
            x = torch.arange(1.0, 6.0, device=dev)
            exc, total = axis_exclusive_scan(x, mesh, "data")
            res["scan_ok"] = bool(torch.equal(exc, torch.zeros_like(x))
                                  and total is x)
            stack.enter_context(set_mesh(mesh))
            stack.enter_context(logical_axis_rules(activation_rules(cfg,
                                                                    mesh)))
        torch.cuda.synchronize()
        res["before_bytes"] = torch.cuda.memory_allocated()
        with compact_routes() as routes:
            result = run_train(f"mesh-{side}", cfg, dev, smi,
                               shards=TRAIN_SHARDS, rows=TRAIN_ROWS,
                               steps=MESH_STEPS, expected=expected,
                               materialize=side == "plain")
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        if side == "mesh":
            torch.save([[t.cpu() for t in r] for r in routes], MESH_ROUTES)
        del routes
        lm, hist, per_step = result[0], result[4], result[5]
        res["losses"] = [row["loss"] for row in hist]
        res["grad_norms"] = [row["grad_norm"] for row in hist]
        res["counts"] = per_step
        names, params = zip(*lm.named_parameters())
        with ThreadPoolExecutor(8) as pool:   # sha256 lets go of the GIL
            res["params"] = dict(zip(names, pool.map(
                lambda p: _digest(to_local(p)), params)))
        res["n_params"] = sum(p.numel() for p in lm.parameters())
    Path(out).write_text(json.dumps(res))
    return 0


def plan_state_bytes(cfg, mesh_shape=(16, 16), axes=("data", "model")
                     ) -> int:
    """The bytes of the train state a rank of the ``axes`` mesh holds
    under the sharding plans: each leaf of the parameters and both AdamW
    moments with every dim divided by its axes' sizes, and the step."""
    from repro_torch.launch.shardings import state_pspecs
    from repro_torch.models.common import param_tree
    from repro_torch.optim.adamw import AdamWState, tree_items
    from repro_torch.train.state import TrainState

    mesh = SimpleNamespace(axis_names=tuple(axes),
                           devices=np.empty(mesh_shape, dtype=object))
    sizes = dict(zip(mesh.axis_names, mesh_shape))
    params = param_tree(LM(cfg, device="meta"))
    specs = state_pspecs(TrainState(params, AdamWState(None, params, params)),
                         cfg, mesh)
    moment = torch.empty((), dtype=dtype_of(cfg.moments_dtype))
    total = 4                                   # the int32 step
    for tree, itemsize in ((specs.params, None), (specs.opt.m, moment),
                           (specs.opt.v, moment)):
        for path, p in tree_items(params):
            spec = tree
            for key in path:
                spec = spec[key]
            n = 1
            for dim, part in zip(p.shape, spec + (None,) * p.dim()):
                axes = (part,) if isinstance(part, str) else (part or ())
                n *= dim // math.prod(sizes[a] for a in axes)
            total += n * (p.element_size() if itemsize is None
                          else itemsize.element_size())
    return total


def phase_mesh(smi: str, dryrun):
    """Phase 15; returns 15a's launches of each kernel over its sharded
    run, 15c's over its split runs, 15a's losses and gradient norms and
    15c(c)'s step time, peak and profile on rank 0. 15b has run on the
    host since phase 2 (``dryrun``: ``start_dryrun``'s CPU-only child, the
    fake world), so that the phase stays within its time."""
    launches, mesh_run = phase_mesh_train(smi)
    tp, tp_run = phase_tp(smi, mesh_run)
    phase_dryrun(*dryrun)
    return launches, tp, mesh_run, tp_run


def _mesh_side(side: str, smi: str) -> dict:
    """One side of 15a in its own child process; its result."""
    MESH_OUT.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           MESH_CHILD, side, str(MESH_OUT), smi],
                          capture_output=True, text=True, timeout=300)
    for line in proc.stdout.splitlines():
        if line.startswith("[mesh-"):
            log(line)
    if proc.returncode:
        fail(f"mesh: the {side} child exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    res = json.loads(MESH_OUT.read_text())
    MESH_OUT.unlink()
    res["child_s"] = time.perf_counter() - t0
    return res


def phase_mesh_train(smi: str):
    """15a: the unsharded and the (1, 1)-mesh run, each in its own child;
    returns the sharded run's launches and its losses and gradient norms
    a step."""
    plain = _mesh_side("plain", smi)
    sharded = _mesh_side("mesh", smi)
    if sharded["backend"] != "nccl" or sharded["mesh_shape"] != [
            [1, 1], ["data", "model"]]:
        fail(f"mesh: backend {sharded['backend']}, mesh "
             f"{sharded['mesh_shape']}")
    if not sharded["scan_ok"]:
        fail("mesh: the axis scan over a size-1 axis is not (0, x)")
    same = plain["params"] == sharded["params"]
    if sharded["losses"] != plain["losses"] or not same:
        fail(f"mesh: the (1, 1) mesh's losses {sharded['losses']} or "
             f"parameters differ from the unsharded run's "
             f"{plain['losses']} (params equal: {same})")
    log(f"[mesh] NCCL world of 1 up in {sharded['init_s']:.2f}s; axis scan "
        f"over a size-1 axis = (0, x); {MESH_STEPS} steps on the (1, 1) "
        f"mesh equal the unsharded ones bit for bit: losses "
        f"{sharded['losses']}, all {sharded['n_params']:,} parameters "
        f"(sha256 each); launches a step as 14b's")
    for res in (plain, sharded):
        log(f"[mesh-{res['side']}] own process: {res['before_bytes']:,} "
            f"bytes on the card before the run, peak "
            f"{res['peak_bytes']:,} bytes ({res['peak_bytes'] / 1e9:.2f} "
            f"GB); child {res['child_s']:.1f}s ({smi})")
    return {name: sum(c[name] for c in sharded["counts"])
            for name in sharded["counts"][0]}, {
                "losses": sharded["losses"],
                "grad_norms": sharded["grad_norms"]}


@contextlib.contextmanager
def kernel_shapes():
    """Records the shapes each kernel's wrapper is called with (first
    call of each shape), by name: flash (q and k, (B, H, S, hd)), the
    scan (da, (B, S, N, di)), dispatch positions (the top-k, (G, T, k))."""
    seen: dict[str, list] = {}
    real = {name: getattr(ops, name) for name in (
        "flash_attention", "mamba_scan", "dispatch_positions_levels")}

    def wrap(name, fn):
        def call(*args, **kw):
            shape = [list(a.shape) for a in args[:2]
                     if isinstance(a, torch.Tensor)]
            if shape not in seen.setdefault(name, []):
                seen[name].append(shape)
            return fn(*args, **kw)
        return call
    for name, fn in real.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


class _PlainScan(torch.autograd.Function):
    """The scan's plain versions as a pair, forward (``ref.mamba_scan_ref``)
    and backward (``ref.mamba_scan_bwd_ref``), as ``ops._MambaScan`` pairs
    the kernels: autograd through the plain forward's loop would build one
    full-size gradient buffer a step, S^2 work."""

    @staticmethod
    def forward(ctx, da, dbx):
        h = ref.mamba_scan_ref(da, dbx)
        ctx.save_for_backward(da, h)
        ctx.dtypes = (da.dtype, dbx.dtype)
        return h

    @staticmethod
    def backward(ctx, g):
        da, h = ctx.saved_tensors
        gda, gdbx = ref.mamba_scan_bwd_ref(da, h, g)
        return gda.to(ctx.dtypes[0]), gdbx.to(ctx.dtypes[1])


@contextlib.contextmanager
def plain_scan_pair():
    """``ops.mamba_scan`` on CPU tensors through ``_PlainScan``."""
    real = ops.mamba_scan
    ops.mamba_scan = _PlainScan.apply
    try:
        yield
    finally:
        ops.mamba_scan = real


def whole_routes(calls, batch):
    """Every rank's MoE dispatches (``(logits, DispatchResult)`` in call
    order, its rows) gathered in the batch's row order, each call's
    logits and ``ROUTE_FIELDS`` on the host (ranks that hold the same rows
    give them once): the whole batch's routing, as an unsharded run makes
    it (a collective)."""
    import torch.distributed as dist

    mine = [(lg.cpu(), {f: getattr(r, f).cpu() for f in ROUTE_FIELDS})
            for lg, r in calls]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (batch.index, mine))
    blocks = [recs for _, recs in sorted(dict(every).items())]
    return [(torch.cat([b[j][0] for b in blocks]),
             SimpleNamespace(**{f: torch.cat([b[j][1][f] for b in blocks])
                                for f in ROUTE_FIELDS}))
            for j in range(len(blocks[0]))]


def tp_grads(tag, cfg, mesh, dev, rank, expected, watch=False):
    """15c(a), (b) and 17(b): ``cfg``'s loss and gradients (float32, remat
    on) with the compute split over the mesh (15c: the (1, 2) mesh's
    ``model`` axis, the kernels on the rank's heads and channels; 17: the
    (2, 1, 1) mesh's ``expert`` axis, each rank its row and its experts),
    against the unsharded LM's on the CPU (rank 0), which runs their plain
    versions (the scan's forward and backward as a pair, ``_PlainScan``),
    from the same weights (a CUDA generator seeded 0, drawn one leaf at a
    time into the shards) and batch: the loss (every rank's share summed)
    within LOSS_RTOL relative, every gradient, gathered from the ranks,
    within GRAD_TOL x its leaf's max|g| (phase 14d's bounds). A batch
    whose top-k flips at a near tie between the two runs (every rank's
    routing gathered) is reported and the next one tried (rank 0 decides,
    the ranks agree by a broadcast). The split run's launches must equal
    ``expected``. With ``watch`` the split run's collectives are recorded
    (``launch.dryrun.Recorder``: kind, mesh dim, shape). Returns the
    record."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import Recorder, mesh_groups
    from repro_torch.launch.shardings import activation_rules
    from repro_torch.models.distributed import gather_full
    from repro_torch.optim import constant
    from repro_torch.optim.adamw import tree_items
    from repro_torch.train.sharded import shard_state

    t_case = time.perf_counter()
    lm = LM(cfg, device=dev, materialize=False).requires_grad_(True)
    opt = AdamW()
    state, sharding = shard_state(
        lm, opt, mesh, activation_rules(cfg, mesh),
        torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(lm, opt, constant(TRAIN_LR), remat=True,
                           sharding=sharding)
    ref = card_and_host(cfg, dev)[1] if rank == 0 else None
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    calls = []
    plain_dispatch = moe_mod.dispatch_grouped

    def recording(logits, **kw):
        res = plain_dispatch(logits, **kw)
        calls.append((logits.detach(), res))
        return res
    rec = {"split": sharding.split.flags()}
    moe_mod.dispatch_grouped = recording
    try:
        for attempt in range(TP_TRIES):
            tokens = rng.integers(0, cfg.vocab_size, (GRAD_ROWS, GRAD_SEQ))
            labels = np.roll(tokens, -1, axis=1)
            labels[:, -1] = -1
            batch = {"tokens": tokens, "labels": labels}
            calls.clear()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recorder = Recorder(mesh_groups(mesh)) if watch else \
                contextlib.nullcontext()
            with kernel_shapes() as shapes, recorder:
                loss, _, grads = step.loss_grads(state.params, batch)
            torch.cuda.synchronize()
            rec["split_s"] = time.perf_counter() - t0
            if watch:
                rec["collectives"] = [
                    (c["kind"], c["axis"], c["shape"], c["bytes"])
                    for c in recorder.collectives]
            loss = sharding.batch.sum_(loss.detach().clone())
            counts = ops.launch_counts()
            want = {name: expected.get(name, 0) for name in counts}
            if counts != want:
                fail(f"{tag}: launches {counts}, expected {want}")
            rec["counts"], rec["shapes"] = counts, shapes
            whole = {".".join(p): gather_full(g, mesh, sharding.param[p])
                     for p, g in tree_items(grads)}
            again = torch.zeros((), device=dev)
            on_split = whole_routes(calls, sharding.batch)
            calls.clear()
            if rank == 0:
                t_ref = time.perf_counter()
                with plain_scan_pair():
                    lh, gh = loss_grads(ref, batch)
                rec["plain_s"] = time.perf_counter() - t_ref
                tie = routing_tie(tag, on_split, list(calls),
                                  cfg.experts_per_token)
                if tie is None:
                    rec["worst"] = grads_close(tag, loss, whole, lh, gh)
                    rec["loss"], rec["plain_loss"] = loss.item(), lh.item()
                else:
                    log(f"[{tag}] batch {attempt}: top-k decided by a near "
                        f"tie (gap {tie:.2e}) between the split and the "
                        f"unsharded run; the next batch")
                    again.fill_(1.0)
                del gh
            dist.broadcast(again, src=0)
            del whole, grads
            if not again.item():
                break
        else:
            fail(f"{tag}: every batch diverged at a near tie")
    finally:
        moe_mod.dispatch_grouped = plain_dispatch
    rec["attempts"] = attempt + 1
    rec["experts_local"] = len(lm.stages[0].ffn.moe.wi.to_local()) \
        if cfg.n_experts else 0
    log(f"[{tag.split('-')[0]}-{rank}] {tag}: split loss and gradients "
        f"{rec['split_s']:.2f}s"
        f", the unsharded on the CPU {rec.get('plain_s', 0.0):.2f}s, "
        f"{time.perf_counter() - t_case:.1f}s for the case")
    rec["local_bytes"] = sum(p.to_local().numel() * p.to_local().element_size()
                             for p in lm.parameters())
    rec["whole_bytes"] = sum(p.numel() * p.element_size()
                             for p in lm.parameters())
    del lm, state, ref
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def gloo_profile(fn) -> dict:
    """``fn()`` (which ends synchronised) under torch.profiler: the wall,
    the host time inside gloo's collectives (``gloo:`` events), in all
    and by kind (calls, ms), and the device's busy time, in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    gloo = [e for e in events if e.key.startswith("gloo:")]
    by_kind = {}        # key_averages may give a kind more than one entry
    for e in gloo:
        n, ms = by_kind.get(e.key, (0, 0.0))
        by_kind[e.key] = (n + e.count, ms + e.cpu_time_total / 1e3)
    return {"wall_ms": wall * 1e3,
            "gloo_ms": sum(e.cpu_time_total for e in gloo) / 1e3,
            "gloo_calls": sum(e.count for e in gloo),
            "gloo_by_kind": by_kind,
            "busy_ms": sum(getattr(e, "self_device_time_total", 0.0)
                           for e in events if e.device_type
                           == torch.autograd.DeviceType.CUDA) / 1e3}


def gloo_kinds(prof: dict) -> str:
    """A profile's gloo host time by kind: "kind ms in calls", ..."""
    return ", ".join(f"{k[5:]} {ms:.1f} ms in {n}" for k, (n, ms) in
                     sorted(prof["gloo_by_kind"].items()))


def tp_profile(lm, pipe, dev) -> dict:
    """One more loss and gradients of 15c(c)'s or 17(c)'s split LM (the
    step without its update), profiled (``gloo_profile``)."""
    batch = {k: lm.batch.rows(torch.as_tensor(v, device=dev))
             for k, v in pipe.batch(MESH_STEPS)[0].items()}
    params = list(lm.parameters())

    def run():
        loss, _ = lm.loss(batch, remat=True)
        torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
    return gloo_profile(run)


def split_train(tag: str, mesh, dev, smi: str, rank: int, want: dict,
                routes=None) -> dict:
    """15c(c) and 17(c): granite at full width and depth in bf16 trained
    MESH_STEPS steps through ``run_train`` under ``set_mesh`` and the
    mesh's activation rules, as ``launch.train`` trains, its LM built on
    meta and drawn one leaf at a time: each step's launches 14b's, its
    loss within TP_LOSS_RTOL and its gradient norm within TP_GNORM_RTOL
    relative of ``want``'s (15a's (1, 1) run); with ``routes`` (15a's
    routing, ``compact_routes``) on that run's routing of the rank's rows
    (``replayed_routes``); then one loss and its gradients profiled
    (``tp_profile``). Returns the record."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.shardings import activation_rules
    from repro_torch.models.common import logical_axis_rules
    from repro_torch.models.distributed import BatchGroup

    cfg = get_config(ARCH)
    n = cfg.n_layers
    expected = {"flash_attention": 2 * n, "flash_attention_tc": 2 * n,
                "flash_attention_bwd": n, "flash_attention_bwd_tc": n,
                "dispatch_positions": 2 * n}
    rules = activation_rules(cfg, mesh)
    batch = BatchGroup(mesh, rules["batch"])
    n_rows = TRAIN_SHARDS * TRAIN_ROWS // batch.ranks
    replay = (replayed_routes(routes, slice(batch.index * n_rows,
                                            (batch.index + 1) * n_rows))
              if routes is not None else contextlib.nullcontext([]))
    with set_mesh(mesh), logical_axis_rules(rules):
        with kernel_shapes() as shapes, replay as turned:
            result = run_train(f"{tag}-{rank}", cfg, dev, smi,
                               shards=TRAIN_SHARDS, rows=TRAIN_ROWS,
                               steps=MESH_STEPS, expected=expected,
                               materialize=False)
        lm, pipe, hist, per_step = (result[0], result[3], result[4],
                                    result[5])
        profiled = tp_profile(lm, pipe, dev)
    losses = [row["loss"] for row in hist]
    norms = [row["grad_norm"] for row in hist]
    for got, ref, tol in ((losses, want["losses"], TP_LOSS_RTOL),
                          (norms, want["grad_norms"], TP_GNORM_RTOL)):
        if len(got) != len(ref) or not all(
                abs(a - b) <= tol * abs(b) for a, b in zip(got, ref)):
            fail(f"{tag}-{rank}: {got} against the (1, 1) run's {ref} "
                 f"(bound {tol} relative)")
    return {"losses": losses, "grad_norms": norms, "counts": per_step,
            "turned": turned, "dts": [row["dt"] for row in hist],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "shapes": shapes, "profile": profiled,
            "split": lm.split.flags(),
            "wq_local": list(lm.stages[0].attn.wq.w.to_local().shape),
            "experts_local": len(lm.stages[0].ffn.moe.wi.to_local()),
            "local_bytes": sum(p.to_local().numel()
                               * p.to_local().element_size()
                               for p in lm.parameters())}


def gloo_child(tag: str, rank: int, port: int, out: str, timeout: float,
               shape, axes, body) -> int:
    """Rank ``rank`` of TP_RANKS processes sharing the card: a gloo world
    (tcp://localhost at ``port``) and the ``shape`` mesh of ``axes`` on it
    (``init_device_mesh`` on the card), then ``body(mesh, dev, rank)``,
    whose record it writes to ``out`` as JSON with the backend, the mesh
    and the world's set-up time. On an error it prints it and leaves at
    once, without the group's teardown, which would wait on the other
    ranks; a rank still running after ``timeout`` less 30 s prints every
    thread's stack."""
    import faulthandler
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faulthandler.dump_traceback_later(timeout - 30, exit=False)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=TP_RANKS, rank=rank)
    try:
        res = {"rank": rank, "backend": dist.get_backend(),
               "init_s": time.perf_counter() - t0}
        mesh = init_device_mesh("cuda", tuple(shape), mesh_dim_names=axes)
        res["mesh_shape"] = [list(mesh.shape), list(mesh.mesh_dim_names)]
        res.update(body(mesh, dev, rank))
    except BaseException as exc:
        log(f"[{tag}-{rank}] {type(exc).__name__}: {exc}")
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))
    return 0


def tp_child(rank: int, port: int, out: str, smi: str, want: str) -> int:
    """15c, rank ``rank`` of two processes sharing the card on the (1, 2)
    ("data", "model") mesh (``gloo_child``): (a) granite at full width cut
    to 2 layers and (b) falcon-mamba-7b at full width cut to 2 layers,
    float32, against the unsharded LM (``tp_grads``), and (c) granite at
    full width and depth in bf16 (``split_train``) against ``want``'s
    losses and gradient norms (15a's (1, 1) run, JSON)."""
    def body(mesh, dev, rank):
        n = GRAD_LAYERS
        granite = dataclasses.replace(get_config(ARCH), n_layers=n,
                                      dtype="float32")
        falcon = dataclasses.replace(get_config(SSM_ARCH), n_layers=n,
                                     dtype="float32")
        return {"a": tp_grads("tp-granite-grads", granite, mesh, dev, rank,
                              {"flash_attention": 2 * n,
                               "flash_attention_bwd": n,
                               "dispatch_positions": 2 * n}),
                "b": tp_grads("tp-falcon-grads", falcon, mesh, dev, rank,
                              {"mamba_scan": 2 * n, "mamba_scan_bwd": n}),
                "c": split_train("tp", mesh, dev, smi, rank,
                                 json.loads(want))}
    return gloo_child("tp", rank, port, out, TP_TIMEOUT, (1, TP_RANKS),
                      ("data", "model"), body)


def card_ranks(tag: str, flag: str, out_dir: Path, timeout: float, *args):
    """TP_RANKS child processes (``chip_smoke.py FLAG RANK PORT OUT
    *ARGS``), one gloo rank each (tcp://localhost at a free port), share
    the card; all must end within ``timeout``. Prints rank 0's lines
    tagged ``[TAG-`` and the others' own; fails with both logs' ends
    where a rank exits non-zero. Returns (each rank's JSON record, the
    ranks' wall seconds)."""
    import socket

    out_dir.mkdir(parents=True, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs, logs = [], []
    for rank in range(TP_RANKS):
        (out_dir / f"rank{rank}.json").unlink(missing_ok=True)
        logs.append(open(out_dir / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag,
             str(rank), str(port), str(out_dir / f"rank{rank}.json"), *args],
            stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    try:
        # until all end, one fails (the others may wait on it) or the time
        # is up
        while time.monotonic() < deadline and not all(
                proc.poll() == 0 for proc in procs) and not any(
                proc.poll() for proc in procs):
            time.sleep(0.5)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    texts = [(out_dir / f"rank{r}.log").read_text() for r in range(TP_RANKS)]
    for r, text in enumerate(texts):
        for line in text.splitlines():
            if line.startswith(f"[{tag}-" if r == 0 else f"[{tag}-{r}]"):
                log(line)
    codes = [proc.returncode for proc in procs]
    if codes != [0] * TP_RANKS:
        fail(f"{tag}: the ranks exited {codes} after {wall:.1f}s: "
             f"{texts[0][-2500:]} || {texts[1][-2500:]}")
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(TP_RANKS)], wall


def phase_tp(smi: str, mesh_run: dict) -> dict:
    """15c: two processes, one gloo rank each, share the card on the
    (1, 2) mesh (``tp_child``); both must end within TP_TIMEOUT. Returns
    the launches of each kernel over (c)'s run on rank 0, the scan's from
    (b)."""
    ranks, wall = card_ranks("tp", TP_CHILD, TP_OUT, TP_TIMEOUT, smi,
                             json.dumps(mesh_run))
    r0 = ranks[0]
    if any(r["backend"] != "gloo" or r["mesh_shape"] != [
            [1, TP_RANKS], ["data", "model"]] for r in ranks):
        fail(f"tp: backends {[r['backend'] for r in ranks]}, meshes "
             f"{[r['mesh_shape'] for r in ranks]}")
    for case, keys in (("a", ("heads", "ff", "vocab", "experts")),
                       ("b", ("vocab", "inner"))):
        if not all(r[case]["split"][k] for r in ranks for k in keys):
            fail(f"tp: case {case} did not split {keys}: "
                 f"{[r[case]['split'] for r in ranks]}")
    c = [r["c"] for r in ranks]
    if c[0]["losses"] != c[1]["losses"] or \
            c[0]["grad_norms"] != c[1]["grad_norms"]:
        fail(f"tp: the ranks' losses or gradient norms differ: "
             f"{c[0]['losses']} {c[0]['grad_norms']}, {c[1]['losses']} "
             f"{c[1]['grad_norms']}")
    if not all(r["split"]["heads"] and r["split"]["experts"]
               and r["split"]["vocab"] for r in c):
        fail(f"tp: case c's split {[r['split'] for r in c]}")
    for case, name in (("a", ARCH), ("b", SSM_ARCH)):
        rec = r0[case]
        log(f"[tp] {name} x {GRAD_LAYERS} layers f32 ({GRAD_ROWS}x"
            f"{GRAD_SEQ}) on the (1, 2) mesh, split {rec['split']}: loss "
            f"{rec['loss']:.6f} vs unsharded on the CPU (plain versions) "
            f"{rec['plain_loss']:.6f}, every "
            f"gradient within {rec['worst']:.3e} x its max|g| (bound "
            f"{GRAD_TOL}; batch {rec['attempts']} of {TP_TRIES}); "
            f"launches {dict((k, v) for k, v in rec['counts'].items() if v)}"
            f", local shapes {rec['shapes']}; a rank holds "
            f"{rec['local_bytes'] / 1e9:.3f} of {rec['whole_bytes'] / 1e9:.3f}"
            f" GB of weights; {rec['split_s']:.2f}s for the split loss and "
            f"gradients")
    tokens = TRAIN_SHARDS * TRAIN_ROWS * TRAIN_SEQ
    for r in c:
        steady = r["dts"][1:] or r["dts"]
        mean_dt = sum(steady) / len(steady)
        r["mean_dt"] = mean_dt
    log(f"[tp] {ARCH} full width and depth bf16 on the (1, 2) mesh, "
        f"{MESH_STEPS} steps: losses {c[0]['losses']} vs the (1, 1) run's "
        f"{mesh_run['losses']} (bound {TP_LOSS_RTOL} relative), gradient "
        f"norms {c[0]['grad_norms']} vs {mesh_run['grad_norms']} (bound "
        f"{TP_GNORM_RTOL} relative); wq local "
        f"{c[0]['wq_local']}, {c[0]['experts_local']} experts a rank; "
        f"step time {c[0]['mean_dt'] * 1e3:.1f} / {c[1]['mean_dt'] * 1e3:.1f}"
        f" ms (ranks 0 / 1, steps 1-{MESH_STEPS - 1}), "
        f"{tokens / c[0]['mean_dt']:.0f} tokens/s, peak "
        f"{c[0]['peak_bytes']:,} / {c[1]['peak_bytes']:,} bytes "
        f"({c[0]['peak_bytes'] / 1e9:.2f} / {c[1]['peak_bytes'] / 1e9:.2f} "
        f"GB), weights {c[0]['local_bytes'] / 1e9:.3f} GB a rank; launches "
        f"a step {c[0]['counts'][-1]}, local shapes {c[0]['shapes']}; "
        f"gloo up in {r0['init_s']:.2f}s, 15c {wall:.1f}s ({smi})")
    for r, res in enumerate(c):
        prof = res["profile"]
        log(f"[tp] rank {r}, one loss and gradients under torch.profiler: "
            f"{prof['wall_ms']:.1f} ms, of it {prof['gloo_ms']:.1f} ms of "
            f"host time in {prof['gloo_calls']} gloo collectives "
            f"({gloo_kinds(prof)}), device busy "
            f"{prof['busy_ms']:.1f} ms ({smi})")
    launches = {name: sum(s[name] for s in c[0]["counts"])
                for name in c[0]["counts"][0]}
    launches["mamba_scan"] = r0["b"]["counts"]["mamba_scan"]
    launches["mamba_scan_bwd"] = r0["b"]["counts"]["mamba_scan_bwd"]
    shutil.rmtree(TP_OUT, ignore_errors=True)
    return launches, {"mean_dt": c[0]["mean_dt"],
                      "peak_bytes": c[0]["peak_bytes"],
                      "profile": c[0]["profile"]}


SPLIT_CHILD = "--split-child"  # 16: two gloo ranks serve on the (1, 2) mesh
SPLIT_LENS = (137, 503, 712, 900)   # 16(a): rank 1's block [512, 1024)
SPLIT_MAX_LEN = 1024                # past rows 0-1, row 1 crosses in decode
SPLIT_STEPS = 10      # row 1 (503) crosses 512 at the 10th (was 16)
SPLIT_TRIES = 3         # 16(a): prompt sets tried past routing near ties
SPLIT_PROMPTS = 8       # 16(b): granite-serve's first 8 prompts
SPLIT_B_MAX_LEN = 4096
# 16(b) at 6 of granite's 24 layers and 32 decode steps (was 24 layers and
# 64 steps), to keep the script within its time with phase 17
SPLIT_B_LAYERS = 6
SPLIT_B_STEPS = 32
# 16(b), bf16 at full depth against the unsharded run on the card, on its
# routing: each rank rounds its partial sums to bf16 before the
# all-reduce (phase 15c(c): losses 4.4e-5 and gradient norms ~1% apart);
# through 24 layers and a 49,408-wide product that gives logits ~1e-2 x
# max|logit| apart, while a block attended with the wrong mask or merge
# moves them by O(1)
SPLIT_BF16_TOL = 5e-2
SPLIT_TIMEOUT = 300
SPLIT_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_split"


def split_prompts(cfg, lens, rng):
    """Right-padded prompts of ``lens`` real tokens, (B, max) int64."""
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
    return toks, np.asarray(lens, np.int32)


def split_run(lm, cache, toks, lens, feed, dev):
    """Prefill, then a decode step a row of ``feed`` (S, B): the logits of
    each call (B, V), the cache, the prefill's and each step's seconds."""
    out, times = [], []
    t0 = time.perf_counter()
    logits, cache = lm.prefill(cache, toks, lens)
    out.append(logits)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    for step, nxt in enumerate(feed):
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(cache, nxt[:, None], lens + step)
        out.append(logits[:, 0])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, cache, times


def _kv_rows(cache, lens):
    """(the cache's KV leaves cut to the rows below each length, its SSM
    leaves), each as a list of tensors."""
    nodes = list(cache.values()) if isinstance(cache, dict) else [cache]
    kv, ssm = [], []
    for node in nodes:
        for t in node:
            if t.dim() == 5:
                kv.extend(t[:, i, :n] for i, n in enumerate(lens))
            else:
                ssm.append(t)
    return kv, ssm


ROUTE_FIELDS = ("expert_idx", "slot_idx", "keep", "weight")


@contextlib.contextmanager
def routing(replay=None):
    """Every MoE dispatch recorded as it is made, (router logits,
    ``DispatchResult``) in call order, on its device; with ``replay``
    (``ROUTE_FIELDS`` of such a record, in call order) each call takes the
    recorded routing in its place (the positions kernel still runs)."""
    plain = moe_mod.dispatch_grouped
    record = []

    def call(logits, **kw):
        res = plain(logits, **kw)
        if replay is not None:
            res = dataclasses.replace(res, **{
                f: replay[len(record)][f].to(logits.device)
                for f in ROUTE_FIELDS})
        record.append((logits.detach(), res))
        return res
    moe_mod.dispatch_grouped = call
    try:
        yield record
    finally:
        moe_mod.dispatch_grouped = plain


@contextlib.contextmanager
def compact_routes():
    """Every MoE dispatch's choices recorded as it is made, in call order,
    on its device in small types: (expert_idx uint8, slot_idx int16,
    keep), 9 bytes a (token, choice) (a dropped choice's slot is below T
    k)."""
    plain = moe_mod.dispatch_grouped
    record = []

    def call(logits, **kw):
        res = plain(logits, **kw)
        record.append((res.expert_idx.to(torch.uint8),
                       res.slot_idx.to(torch.int16), res.keep.clone()))
        return res
    moe_mod.dispatch_grouped = call
    try:
        yield record
    finally:
        moe_mod.dispatch_grouped = plain


@contextlib.contextmanager
def replayed_routes(routes, rows: slice):
    """Each MoE dispatch takes a recorded run's choices (``compact_routes``,
    in call order) for the rows ``rows`` of its batch in place of its own,
    its combine weights computed from its own router logits at those
    choices as ``sched.moe_dispatch`` computes them (the router keeps its
    gradient); the positions kernel still runs. Yields [tokens whose set
    of experts its own routing would have turned, tokens dispatched], a
    device tensor."""
    plain = moe_mod.dispatch_grouped
    calls = iter(routes)
    turned = None

    def call(logits, **kw):
        nonlocal turned
        res = plain(logits, **kw)
        e, slot, keep = (t[rows].to(logits.device) for t in next(calls))
        e, slot = e.int(), slot.int()
        diff = (res.expert_idx.sort(-1).values != e.sort(-1).values).any(-1)
        count = torch.stack([diff.sum(), torch.tensor(
            diff.numel(), device=diff.device)])
        turned = count if turned is None else turned + count
        probs = torch.softmax(logits.float(), dim=-1)
        w = torch.gather(probs, 2, e.long()) * keep
        denom = w.sum(2, keepdim=True)
        w = torch.where(denom > 0, w / denom.clamp_min(1e-9),
                        torch.zeros((), device=w.device))
        return dataclasses.replace(res, expert_idx=e, slot_idx=slot,
                                   keep=keep, weight=w)
    moe_mod.dispatch_grouped = call
    out = []
    try:
        yield out
    finally:
        moe_mod.dispatch_grouped = plain
        out.extend(turned.tolist() if turned is not None else [0, 0])


def split_vs_plain(tag, cfg, mesh, dev, rank, lengths=SPLIT_LENS,
                   max_len=SPLIT_MAX_LEN, steps=SPLIT_STEPS):
    """16(a) and 17(b): ``cfg`` (float32) served split over the mesh (16:
    the (1, 2) mesh's ``model`` axis; 17: the (2, 1, 1) mesh's
    ``expert`` axis, a row a rank) from weights drawn one leaf at a time
    into the shards (a CUDA generator seeded 0), against the unsharded LM
    on the CPU (rank 0; the same weights, the plain versions): prompts of
    ``lengths`` prefilled into caches of ``max_len``, then ``steps``
    decode steps fed the CPU's greedy tokens (broadcast), each rank on its
    rows. Every call's logits (gathered over the rows) within LOGIT_TOL x
    max|logit|, the greedy tokens equal, the cache gathered from the ranks
    within LOGIT_TOL x its max of the CPU's on the rows below each length
    (and the SSM caches whole). A prompt set whose MoE top-k flips at a
    near tie between the two runs (every rank's routing gathered) is
    reported and the next one tried (rank 0 decides, the ranks agree by a
    broadcast). Returns the record."""
    import torch.distributed as dist

    from repro_torch.launch.shardings import (
        activation_rules,
        placements,
        serve_shape,
    )
    from repro_torch.models.distributed import gather_full
    from repro_torch.train.sharded import gather_cache, shard_params

    t_case = time.perf_counter()
    b = len(lengths)
    lm = LM(cfg, device=dev, materialize=False)
    rules = activation_rules(cfg, mesh, serve_shape(b, max_len))
    shard_params(lm, mesh, rules, torch.Generator(device=dev).manual_seed(0))
    by_rows = placements(mesh, (rules["batch"], None))
    rows = lm.batch.rows
    host = card_and_host(cfg, dev)[1] if rank == 0 else None
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    rec = {"split": lm.split.flags(), "moves": lm.split.moves}
    with routing() as calls:
        for attempt in range(SPLIT_TRIES):
            toks, lens = split_prompts(cfg, lengths, rng)
            feed = torch.zeros((steps, b), dtype=torch.int64)
            calls.clear()
            if rank == 0:
                t0 = time.perf_counter()
                hc = host.init_cache(b, max_len)
                logits, hc = host.prefill(hc, toks, lens)
                want = [logits]
                for step in range(steps):
                    feed[step] = logits.argmax(-1)
                    logits, hc = host.decode_step(hc, feed[step][:, None],
                                                  lens + step)
                    logits = logits[:, 0]
                    want.append(logits)
                rec["plain_s"] = time.perf_counter() - t0
                on_host = list(calls)
                calls.clear()
            dist.broadcast(feed, src=0)
            ops.reset_launch_counts()
            with kernel_shapes() as shapes:
                cache = lm.init_cache(b, max_len)
                got, cache, times = split_run(
                    lm, cache, rows(torch.as_tensor(toks)),
                    rows(torch.as_tensor(lens)).numpy(),
                    rows(feed.T).T.to(dev), dev)
            rec["counts"], rec["shapes"] = ops.launch_counts(), shapes
            rec["cache_shapes"] = [list(t.shape) for t in _leaves(cache)]
            rec["seq"] = [lm.seq.lo, lm.seq.block]
            rec["prefill_s"], rec["step_ms"] = times[0], [
                t * 1e3 for t in times[1:]]
            got = [gather_full(g, mesh, by_rows) for g in got]
            whole = gather_cache(lm, cache)
            on_split = whole_routes(calls, lm.batch)
            again = torch.zeros(())
            if rank == 0:
                tie = routing_tie(tag, on_split, on_host,
                                  cfg.experts_per_token)
                if tie is None:
                    errs = [_max_rel(g, w) for g, w in zip(got, want)]
                    rec["logit_errs"] = errs
                    if not max(errs) <= LOGIT_TOL:
                        fail(f"{tag}: logits differ by {max(errs):.3e} x "
                             f"max|logit| (calls {errs})")
                    chosen = torch.stack([g.argmax(-1).cpu() for g in got])
                    if not (torch.equal(chosen[:-1], feed) and torch.equal(
                            chosen[-1], logits.argmax(-1))):
                        fail(f"{tag}: greedy tokens differ from the CPU's")
                    # rows written: below each length after the last step
                    n = lens + steps
                    kv_g, ssm_g = _kv_rows(whole, n)
                    kv_w, ssm_w = _kv_rows(hc, n)
                    cache_err = max(_max_rel(g, w) for g, w in zip(
                        kv_g + ssm_g, kv_w + ssm_w))
                    rec["cache_err"] = cache_err
                    if not cache_err <= LOGIT_TOL:
                        fail(f"{tag}: the gathered cache differs by "
                             f"{cache_err:.3e} x max")
                else:
                    log(f"[{tag}] prompts {attempt}: top-k decided by a "
                        f"near tie (gap {tie:.2e}) between the split and "
                        f"the unsharded run; the next prompts")
                    again.fill_(1.0)
            dist.broadcast(again, src=0)
            del whole
            if not again.item():
                break
        else:
            fail(f"{tag}: every prompt set diverged at a near tie")
    rec["attempts"] = attempt + 1
    rec["lens"] = lens.tolist()
    plain = (f", the unsharded on the CPU {rec['plain_s']:.2f}s"
             if rank == 0 else "")
    log(f"[{tag.split('-')[0]}-{rank}] {tag}: split prefill "
        f"{rec['prefill_s']:.2f}s, "
        f"decode {sum(rec['step_ms']) / len(rec['step_ms']):.1f} ms a step"
        f"{plain}, {time.perf_counter() - t_case:.1f}s for the case")
    del lm, host, cache
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def split_profile(lm, cache, nxt, lens) -> dict:
    """One more decode step of 16(b)'s split LM, profiled
    (``gloo_profile``)."""
    def run():
        lm.decode_step(cache, nxt[:, None], lens)
        torch.cuda.synchronize()
    return gloo_profile(run)


def split_bf16(cfg, mesh, dev, rank, ref_path):
    """16(b): ``cfg`` (granite at full width cut to SPLIT_B_LAYERS layers)
    in bf16 served split over the (1, 2) mesh, its weights drawn into the
    shards (a CUDA generator seeded 0, as the unsharded run's):
    SPLIT_PROMPTS prompts prefilled into caches of SPLIT_B_MAX_LEN, then
    SPLIT_B_STEPS decode steps fed the unsharded run's tokens
    (``ref_path``), timed, its launches counted (a rank, a layer: a flash
    forward on the tensor cores and a positions launch a prefill, a
    positions launch a decode step) and one more step profiled; rank
    0 reports each call's logits against the unsharded run's, the greedy
    agreement and the top-k choices that differ from its. bf16 rounds the
    two runs' sums apart and a router's top-k turns at a near tie on such
    a difference, which moves a token's expert output by O(1): so the run
    is made again with the unsharded run's routing replayed
    (``routing``), and there each call's logits are held within
    SPLIT_BF16_TOL x max|logit| of the unsharded run's. Returns the
    record."""
    from repro_torch.launch.shardings import activation_rules, serve_shape
    from repro_torch.train.sharded import shard_params

    ref_run = torch.load(ref_path)
    feed = ref_run["feed"].to(dev)
    b, n = SPLIT_PROMPTS, cfg.n_layers
    toks, lens = ref_run["toks"].numpy(), ref_run["lens"].numpy()
    lens_t = torch.as_tensor(lens, device=dev)
    lm = LM(cfg, device=dev, materialize=False)
    shard_params(lm, mesh, activation_rules(cfg, mesh, serve_shape(
        b, SPLIT_B_MAX_LEN)), torch.Generator(device=dev).manual_seed(0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with kernel_shapes() as shapes, routing() as routes:
        cache = lm.init_cache(b, SPLIT_B_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cache, toks, lens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        rec = {"prefill_counts": ops.launch_counts(), "shapes": shapes,
               "prefill_s": prefill_s, "tokens": int(lens.sum()),
               "cache_shapes": [list(t.shape) for t in _leaves(cache)],
               "split": lm.split.flags()}
        got, step_ms, counts = [logits], [], []
        for step in range(SPLIT_B_STEPS):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(cache, feed[step][:, None],
                                           lens_t + step)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts.append({k: v for k, v in ops.launch_counts().items()
                           if v})
            got.append(logits[:, 0])
    want = {"flash_attention": n, "flash_attention_tc": n,
            "dispatch_positions": n}
    if {k: v for k, v in rec["prefill_counts"].items() if v} != want:
        fail(f"split-{rank}: prefill launches {rec['prefill_counts']}, "
             f"expected {want}")
    if any(c != {"dispatch_positions": n} for c in counts):
        fail(f"split-{rank}: decode launches {counts[:2]}..., expected "
             f"{n} positions a step")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["step_ms"] = step_ms
    rec["profile"] = split_profile(lm, cache, feed[-1],
                                   lens_t + SPLIT_B_STEPS)
    if rank == 0:
        rec["free_errs"] = [_max_rel(g, w)
                            for g, w in zip(got, ref_run["logits"])]
        agree = torch.stack([g.argmax(-1).cpu() for g in got]) == \
            ref_run["logits"].argmax(-1)
        rec["agreement"] = agree.float().mean().item()
        # tokens (of every dispatch, prefill padding included) whose set
        # of k experts differs from the unsharded run's
        turned = [(r.expert_idx.cpu().sort(-1).values
                   != w["expert_idx"].sort(-1).values).any(-1)
                  for (_, r), w in zip(routes, ref_run["routes"])]
        rec["turned"] = [sum(int(t.sum()) for t in turned),
                         sum(t.numel() for t in turned)]
    del cache, got, routes
    # the same run on the unsharded run's routing
    with routing(replay=ref_run["routes"]):
        cache = lm.init_cache(b, SPLIT_B_MAX_LEN)
        got, cache, times = split_run(lm, cache, toks, lens, feed, dev)
    rec["warm_prefill_s"] = times[0]
    if rank == 0:
        errs = [_max_rel(g, w) for g, w in zip(got, ref_run["logits"])]
        rec["logit_errs"] = errs
        if not max(errs) <= SPLIT_BF16_TOL:
            fail(f"split-{rank}: bf16 logits on the unsharded run's "
                 f"routing differ by {max(errs):.3e} x max|logit| from its "
                 f"(bound {SPLIT_BF16_TOL})")
    del lm, cache, got
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def split_child(rank: int, port: int, out: str, smi: str, ref: str) -> int:
    """16, rank ``rank`` of two processes sharing the card on the (1, 2)
    ("data", "model") mesh (``gloo_child``): (a) granite and
    falcon-mamba-7b at full width cut to 2 layers in float32, the KV cache
    too (``split_vs_plain``; a bf16 cache rounds values 1e-7 apart to
    neighbouring bf16 values now and then), and (b) granite at full width
    cut to SPLIT_B_LAYERS layers in bf16 (``split_bf16``, the unsharded
    run's tokens, logits and routing in ``ref``)."""
    def body(mesh, dev, rank):
        res = {"a": {}}
        for arch in (ARCH, SSM_ARCH):
            cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                      dtype="float32",
                                      kv_cache_dtype="float32")
            res["a"][arch] = split_vs_plain(f"split-{arch}", cfg, mesh, dev,
                                            rank)
        res["b"] = split_bf16(dataclasses.replace(
            get_config(ARCH), n_layers=SPLIT_B_LAYERS), mesh, dev, rank, ref)
        return res
    return gloo_child("split", rank, port, out, SPLIT_TIMEOUT, (1, TP_RANKS),
                      ("data", "model"), body)


def split_reference(dev, smi: str) -> dict:
    """16(b)'s reference: granite at full width cut to SPLIT_B_LAYERS
    layers in bf16, the unsharded LM on the card, SPLIT_PROMPTS prompts of
    granite-serve's mix prefilled into caches of SPLIT_B_MAX_LEN and
    SPLIT_B_STEPS greedy decode steps; its tokens, logits, MoE routing
    (``routing``) and prompts saved for the ranks. Returns its times and
    peak memory."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=SPLIT_B_LAYERS)
    prompts = serve_prompts(cfg, SPLIT_PROMPTS)
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), PROMPT_HI), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lens_t = torch.as_tensor(lens, device=dev)
    with routing() as routes:
        cache = lm.init_cache(len(prompts), SPLIT_B_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cache, toks, lens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out, feed, step_ms = [logits.cpu()], [], []
        for step in range(SPLIT_B_STEPS):
            feed.append(logits.argmax(-1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(cache, feed[-1][:, None],
                                           lens_t + step)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits = logits[:, 0]
            out.append(logits.cpu())
    rec = {"prefill_s": prefill_s, "step_ms": step_ms,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "tokens": int(lens.sum()), "lens": lens.tolist()}
    torch.save({"feed": torch.stack(feed).cpu(), "logits": torch.stack(out),
                "toks": torch.from_numpy(toks),
                "lens": torch.from_numpy(lens),
                "routes": [{f: getattr(r, f).cpu() for f in ROUTE_FIELDS}
                           for _, r in routes]}, SPLIT_OUT / "ref.pt")
    del lm, cache
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_serve_split(smi: str, dev) -> dict:
    """Phase 16: 16(b)'s unsharded reference on the card, then two
    processes, one gloo rank each, share the card on the (1, 2) mesh
    (``split_child``); both must end within SPLIT_TIMEOUT. Returns the
    launches of each kernel over rank 0's split runs."""
    shutil.rmtree(SPLIT_OUT, ignore_errors=True)
    SPLIT_OUT.mkdir(parents=True)
    plain = split_reference(dev, smi)
    ranks, wall = card_ranks("split", SPLIT_CHILD, SPLIT_OUT, SPLIT_TIMEOUT,
                             smi, str(SPLIT_OUT / "ref.pt"))
    if any(r["backend"] != "gloo" or r["mesh_shape"] != [
            [1, TP_RANKS], ["data", "model"]] for r in ranks):
        fail(f"split: backends {[r['backend'] for r in ranks]}, meshes "
             f"{[r['mesh_shape'] for r in ranks]}")
    r0 = ranks[0]
    for arch, keys, want in (
            (ARCH, ("heads", "kv_heads", "ff", "vocab", "experts"),
             {"flash_attention": 2, "dispatch_positions": 2 * (
                 1 + SPLIT_STEPS)}),
            (SSM_ARCH, ("vocab", "inner"), {"mamba_scan": 2})):
        for r in ranks:
            rec = r["a"][arch]
            if not all(rec["split"][k] for k in keys):
                fail(f"split: {arch} did not split {keys}: {rec['split']}")
            counts = {k: v for k, v in rec["counts"].items() if v}
            if counts != want:
                fail(f"split: {arch} launches {counts}, expected {want}")
        rec = r0["a"][arch]
        steady = rec["step_ms"][1:]
        log(f"[split] {arch} x 2 layers f32 on the (1, 2) mesh, prompts "
            f"{rec['lens']} into caches of {SPLIT_MAX_LEN} (blocks "
            f"{[r['a'][arch]['seq'] for r in ranks]}), {SPLIT_STEPS} decode "
            f"steps: every call's logits within {max(rec['logit_errs']):.3e}"
            f" x max|logit| of the unsharded LM on the CPU (plain versions; "
            f"bound {LOGIT_TOL}), greedy tokens equal, the gathered cache "
            f"within {rec['cache_err']:.3e} x max (prompts {rec['attempts']}"
            f" of {SPLIT_TRIES}); a rank's cache {rec['cache_shapes'][:2]}; "
            f"launches {dict((k, v) for k, v in rec['counts'].items() if v)}"
            f", local shapes {rec['shapes']}; prefill {rec['prefill_s']:.3f}"
            f" s, decode {sum(steady) / len(steady):.1f} ms a step")
    n = SPLIT_B_LAYERS
    b = [r["b"] for r in ranks]
    for r in b:
        steady = r["step_ms"][1:]
        r["mean_ms"] = sum(steady) / len(steady)
    rb = b[0]
    p_steady = plain["step_ms"][1:]
    log(f"[split] {ARCH} full width x {n} layers bf16 on the (1, 2) mesh, "
        f"{SPLIT_PROMPTS} prompts ({rb['tokens']} tokens) into caches of "
        f"{SPLIT_B_MAX_LEN}, {SPLIT_B_STEPS} decode steps fed the unsharded"
        f" run's tokens: on its own routing every call's logits within "
        f"{max(rb['free_errs']):.3e} x max|logit| of the unsharded run on "
        f"the card (median call {np.median(rb['free_errs']):.3e}), "
        f"{rb['turned'][0]} of {rb['turned'][1]} tokens' sets of experts "
        f"turned, "
        f"greedy agreement {rb['agreement']:.4f}; on the unsharded run's "
        f"routing within {max(rb['logit_errs']):.3e} (bound "
        f"{SPLIT_BF16_TOL}); launches a rank: prefill "
        f"{dict((k, v) for k, v in rb['prefill_counts'].items() if v)}, "
        f"{n} positions a decode step; local shapes "
        f"{rb['shapes']}; a rank's cache {rb['cache_shapes'][0]}")
    log(f"[split] prefill {rb['tokens'] / b[0]['warm_prefill_s']:.0f} / "
        f"{rb['tokens'] / b[1]['warm_prefill_s']:.0f} tokens/s (ranks 0 / 1,"
        f" the second prefill; the first "
        f"{rb['tokens'] / b[0]['prefill_s']:.0f}; unsharded "
        f"{plain['tokens'] / plain['prefill_s']:.0f}), decode "
        f"{b[0]['mean_ms']:.1f} / {b[1]['mean_ms']:.1f} ms a step "
        f"(unsharded {sum(p_steady) / len(p_steady):.1f}; steps 1-"
        f"{SPLIT_B_STEPS - 1}), peak {b[0]['peak_bytes']:,} / "
        f"{b[1]['peak_bytes']:,} bytes a rank ({b[0]['peak_bytes'] / 1e9:.2f}"
        f" / {b[1]['peak_bytes'] / 1e9:.2f} GB; unsharded "
        f"{plain['peak_bytes'] / 1e9:.2f} GB); gloo up in "
        f"{r0['init_s']:.2f}s, the ranks {wall:.1f}s ({smi})")
    for r, res in enumerate(b):
        prof = res["profile"]
        log(f"[split] rank {r}, one decode step under torch.profiler: "
            f"{prof['wall_ms']:.1f} ms, of it {prof['gloo_ms']:.1f} ms of "
            f"host time in {prof['gloo_calls']} gloo collectives "
            f"({gloo_kinds(prof)}), device busy "
            f"{prof['busy_ms']:.1f} ms ({smi})")
    launches = {name: rb["prefill_counts"][name] + (
        SPLIT_B_STEPS * n if name == "dispatch_positions"
        else 0) for name in rb["prefill_counts"]}
    launches["mamba_scan"] = r0["a"][SSM_ARCH]["counts"]["mamba_scan"]
    shutil.rmtree(SPLIT_OUT, ignore_errors=True)
    return launches



# ---------------------------------------------------------------------------
# phase 17: expert parallelism over ``expert`` — each rank runs its experts,
# the tokens moved to them by all-to-alls
# ---------------------------------------------------------------------------

EP_CHILD = "--ep-child"  # 17: two gloo ranks on the (2, 1, 1) ep mesh
EP_DRY_CHILD = "--ep-dryrun"
EP_SHAPE = (TP_RANKS, 1, 1)
EP_AXES = ("expert", "data", "model")
# 17(a): the slot tensor (ranks, groups, E/ranks, C, d) of a decode step (a
# row a rank, C = 8) and of 17(c)'s step (two rows of 2,048 a rank, C =
# 640) at granite's widths
EP_A2A_SHAPES = ((TP_RANKS, 1, 16, 8, 1024), (TP_RANKS, 2, 16, 640, 1024))
EP_A2A_REPS = 5
EP_LENS = (377, 900)    # 17(b): a prompt a rank
EP_STEPS = 8
EP_TIMEOUT = 420
EP_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_ep"
EP_DRY_OUT = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_ep_dryrun.json"
EP_LADDER_BYTES = (64, 8 << 20)     # 17(d): a float64 tensor a rank
EP_LADDER_REPS = 5
EP_DRY = 4              # the dry run's ep cell: make_production_mesh(ep=4),
EP_DRY_LAYERS = 2       # granite train_4k cut to 2 of its 24 layers


def ep_all_to_all(mesh, dev, rank) -> dict:
    """17(a): ``models.distributed.all_to_all`` over ``expert`` on CUDA
    tensors (gloo stages them through the host), float32 and bf16, at
    EP_A2A_SHAPES: its result and its backward's against the blocks each
    rank sent (regenerated here from that rank's seed), bit for bit; then
    each case timed over EP_A2A_REPS calls after a warm one. Returns
    {case: ms a call}."""
    import torch.distributed as dist

    from repro_torch.models.distributed import all_to_all

    group = mesh.get_group("expert")

    def sent(r, shape, dtype, salt):
        g = torch.Generator(device=dev).manual_seed(1000 * salt + r)
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in EP_A2A_SHAPES:
            case = f"{str(dtype)[6:]} {list(shape)}"
            x = sent(rank, shape, dtype, 1).requires_grad_(True)
            y = all_to_all(x, group)
            y.backward(sent(rank, shape, dtype, 2))
            want, want_g = (torch.cat([sent(r, shape, dtype, salt).chunk(
                TP_RANKS)[rank] for r in range(TP_RANKS)]) for salt in (1, 2))
            if not (torch.equal(y.detach(), want)
                    and torch.equal(x.grad, want_g)):
                fail(f"ep-{rank}: the all-to-all of {case} is not the "
                     f"blocks sent (forward equal: "
                     f"{torch.equal(y.detach(), want)})")
            x = x.detach()
            del y, want, want_g
            all_to_all(x, group)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(EP_A2A_REPS):
                all_to_all(x, group)
            torch.cuda.synchronize()
            times[case] = (time.perf_counter() - t0) * 1e3 / EP_A2A_REPS
            del x
    torch.cuda.empty_cache()
    return times


def ep_ladder(mesh, dev, rank) -> dict:
    """17(d): ``core.axis_exclusive_scan`` over ``expert`` on CUDA float64
    tensors of EP_LADDER_BYTES (gloo stages them through the host): rank
    0's exclusive sum is zero, rank 1's is the ladder's (x1 + x0) - x1,
    and the total is x0 + x1, bit for bit against the tensors each rank
    sent (regenerated here from that rank's seed); then each size timed
    over EP_LADDER_REPS calls after a warm one. Returns {"ms": {bytes: ms
    a call}, "s": seconds of the whole}."""
    import torch.distributed as dist

    from repro_torch.core import axis_exclusive_scan

    def sent(r, nbytes):
        g = torch.Generator(device=dev).manual_seed(3000 + r)
        return torch.randn(nbytes // 8, generator=g, device=dev,
                           dtype=torch.float64)
    t_all = time.perf_counter()
    times = {}
    for nbytes in EP_LADDER_BYTES:
        x = sent(rank, nbytes)
        exc, total = axis_exclusive_scan(x, mesh, "expert")
        x0, x1 = sent(0, nbytes), sent(1, nbytes)
        want = torch.zeros_like(x) if rank == 0 else (x1 + x0) - x1
        if not (torch.equal(exc, want) and torch.equal(total, x0 + x1)):
            fail(f"ep-{rank}: the ladder over expert of {nbytes} B is not "
                 f"exact (exclusive equal: {torch.equal(exc, want)})")
        del exc, total, x0, x1, want
        axis_exclusive_scan(x, mesh, "expert")
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(EP_LADDER_REPS):
            axis_exclusive_scan(x, mesh, "expert")
        torch.cuda.synchronize()
        times[str(nbytes)] = (time.perf_counter() - t0) * 1e3 / \
            EP_LADDER_REPS
    return {"ms": times, "s": time.perf_counter() - t_all}


def ep_child(rank: int, port: int, out: str, smi: str, want: str) -> int:
    """17, rank ``rank`` of two processes sharing the card on the (2, 1, 1)
    ("expert", "data", "model") mesh (``gloo_child``): (a) the all-to-all
    (``ep_all_to_all``); (b) granite at full width cut to 2 layers in
    float32, each rank its 16 of the 32 experts: the loss and gradients of
    2 x 512 tokens, a row a rank, its collectives recorded
    (``tp_grads``), and a prefill of 2 prompts, a prompt a rank, and
    EP_STEPS decode steps (``split_vs_plain``), each against the
    unsharded LM on the CPU; (c) granite at full width and depth in bf16
    on 14b's data, half a step's rows a rank (``split_train``), against
    ``want``'s losses and gradient norms (15a's (1, 1) run, JSON), on that
    run's routing (MESH_ROUTES): bf16 rounds the two runs' sums apart and
    a router's top-k turns at a near tie on such a difference, which moves
    a token's expert output by O(1) (16(b)); how many tokens' experts
    would have turned is reported; (d) the axis-scan ladder
    (``ep_ladder``)."""
    def body(mesh, dev, rank):
        n = GRAD_LAYERS
        granite = dataclasses.replace(get_config(ARCH), n_layers=n,
                                      dtype="float32")
        return {"a": ep_all_to_all(mesh, dev, rank),
                "d": ep_ladder(mesh, dev, rank),
                "b": tp_grads("ep-granite-grads", granite, mesh, dev, rank,
                              {"flash_attention": 2 * n,
                               "flash_attention_bwd": n,
                               "dispatch_positions": 2 * n}, watch=True),
                "b_serve": split_vs_plain(
                    "ep-granite-serve", dataclasses.replace(
                        granite, kv_cache_dtype="float32"), mesh, dev, rank,
                    EP_LENS, SPLIT_MAX_LEN, EP_STEPS),
                "c": split_train("ep", mesh, dev, smi, rank,
                                 json.loads(want),
                                 torch.load(MESH_ROUTES))}
    return gloo_child("ep", rank, port, out, EP_TIMEOUT, EP_SHAPE, EP_AXES,
                      body)


def ep_dryrun_child(out: str) -> int:
    """17's dry run (``chip_smoke.py --ep-dryrun OUT``, a CPU-only child):
    ``launch.dryrun.lower_cell`` of granite's train_4k cell cut to
    EP_DRY_LAYERS layers on ``make_production_mesh(ep=EP_DRY)`` (a fake
    world of 256 ranks); its record to ``out`` as JSON."""
    from repro_torch.launch.dryrun import lower_cell

    cfg = dataclasses.replace(get_config(ARCH), n_layers=EP_DRY_LAYERS)
    Path(out).write_text(json.dumps(lower_cell(ARCH, "train_4k", False,
                                               cfg=cfg, ep=EP_DRY)))
    return 0


def start_ep_dryrun():
    """``ep_dryrun_child`` started; returns (process, start time)."""
    EP_DRY_OUT.unlink(missing_ok=True)
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), EP_DRY_CHILD,
         str(EP_DRY_OUT)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    atexit.register(proc.kill)      # if a phase fails before it is read
    return proc, time.perf_counter()


def ep_dryrun(proc, t0):
    """17's dry run (``start_ep_dryrun``): its state bytes a rank the
    plan's arithmetic on the (4, 4, 16) mesh, six all-to-alls a layer over
    ``expert`` of the slot tensor's bytes, no all-gather over ``expert``;
    printed."""
    from repro_torch.models.moe import moe_capacity

    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
    if proc.returncode:
        fail(f"ep dryrun: exited {proc.returncode}: {stdout[-2000:]} "
             f"{stderr[-2000:]}")
    rec = json.loads(EP_DRY_OUT.read_text())
    EP_DRY_OUT.unlink()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=EP_DRY_LAYERS)
    shape = (EP_DRY, 256 // (16 * EP_DRY), 16)
    want = plan_state_bytes(cfg, shape, EP_AXES)
    rows = 256 // (EP_DRY * shape[1])
    slot_bytes = rows * cfg.n_experts * moe_capacity(
        4096, cfg.experts_per_token, cfg.n_experts,
        cfg.capacity_factor) * cfg.d_model * 2
    entries = rec["collective_log"]
    moved = [c for c in entries if c["kind"] == "all-to-all"]
    gathered = [c for c in entries if c["kind"] == "all-gather"
                and c["axis"] == "expert"]
    if rec["memory"]["state_bytes"] != want or gathered or len(moved) != \
            6 * EP_DRY_LAYERS or any(c["axis"] != "expert" or c["bytes"]
                                     != slot_bytes for c in moved):
        fail(f"ep dryrun: state bytes {rec['memory']['state_bytes']} (the "
             f"plan's {want}), {len(moved)} all-to-alls "
             f"{[(c['axis'], c['bytes']) for c in moved[:2]]} (slots "
             f"{slot_bytes} bytes), {len(gathered)} all-gathers over "
             f"expert")
    by = rec["collectives"]["by_kind"]
    log(f"[ep-dryrun] {ARCH} train_4k x {EP_DRY_LAYERS} layers on a fake "
        f"world of 256 ranks, (expert, data, model) = {shape}: state "
        f"{rec['memory']['state_bytes']:,} bytes a rank (= the plan's), "
        f"{rec['cost']['flops']:.4e} FLOPs a rank, {len(moved)} "
        f"all-to-alls over expert of {slot_bytes:,} bytes (the slot "
        f"tensor; {by['all-to-all']['bytes']:,} bytes on the wire), no "
        f"all-gather over expert, {rec['collectives']['total_count']} "
        f"collectives in all; done within {time.perf_counter() - t0:.1f}s "
        f"of its start (host "
        f"counts)")


def phase_ep(smi: str, mesh_run: dict, tp_run: dict, dryrun) -> dict:
    """Phase 17: two processes, one gloo rank each, share the card on the
    (2, 1, 1) ("expert", "data", "model") mesh (``ep_child``); every rank
    must end within EP_TIMEOUT. Then the ep cell's dry run, which has run
    on the host since phase 2 (``dryrun``: ``start_ep_dryrun``'s child).
    Returns the launches of each kernel over (c)'s run on rank 0."""
    shutil.rmtree(EP_OUT, ignore_errors=True)
    ranks, wall = card_ranks("ep", EP_CHILD, EP_OUT, EP_TIMEOUT, smi,
                             json.dumps(mesh_run))
    if any(r["backend"] != "gloo" or r["mesh_shape"] != [
            list(EP_SHAPE), list(EP_AXES)] for r in ranks):
        fail(f"ep: backends {[r['backend'] for r in ranks]}, meshes "
             f"{[r['mesh_shape'] for r in ranks]}")
    r0 = ranks[0]
    n = GRAD_LAYERS
    e = get_config(ARCH).n_experts // TP_RANKS
    for r in ranks:
        b, bs, c = r["b"], r["b_serve"], r["c"]
        split = dict.fromkeys(b["split"], False) | {"ep": True}
        over = [(k, shape) for k, axis, shape, _ in b["collectives"]
                if axis == "expert"]
        moved = [shape for k, shape in over if k == "all-to-all"]
        if not (b["split"] == bs["split"] == c["split"] == split
                and bs["moves"] and b["experts_local"] == e
                and c["experts_local"] == e):
            fail(f"ep: splits {b['split']} {bs['split']} {c['split']}, "
                 f"tokens moved in serving: {bs['moves']}, experts a rank "
                 f"{b['experts_local']} / {c['experts_local']} (want {e})")
        if len(moved) != 6 * n or [s for k, s in over if k == "all-gather"]:
            fail(f"ep: the step's collectives over expert: {over[:8]}")
        want = {"flash_attention": 2, "dispatch_positions": 2 * (
            1 + EP_STEPS)}
        counts = {k: v for k, v in bs["counts"].items() if v}
        if counts != want:
            fail(f"ep: serving launches {counts}, expected {want}")
    c = [r["c"] for r in ranks]
    if c[0]["losses"] != c[1]["losses"] or \
            c[0]["grad_norms"] != c[1]["grad_norms"]:
        fail(f"ep: the ranks' losses or gradient norms differ: "
             f"{c[0]['losses']} {c[0]['grad_norms']}, {c[1]['losses']} "
             f"{c[1]['grad_norms']}")
    ep_dryrun(*dryrun)
    for case, ms in r0["a"].items():
        shape = [int(x) for x in case.split("[")[1][:-1].split(", ")]
        nbytes = math.prod(shape) * (4 if case.startswith("float32") else 2)
        log(f"[ep] all-to-all over expert of CUDA {case}: the blocks sent, "
            f"bit for bit, forward and backward; {ms:.2f} / "
            f"{ranks[1]['a'][case]:.2f} ms a call (ranks 0 / 1), "
            f"{nbytes / 2 / (ms * 1e-3) / 1e9:.2f} GB/s of the half that "
            f"crosses ({smi})")
    link = GpuCostModel(alpha=0.0)
    for nbytes, ms in r0["d"]["ms"].items():
        log(f"[ep] core.axis_exclusive_scan over expert of CUDA float64 "
            f"{int(nbytes):,} B a rank: exclusive sums and total exact; "
            f"{ms:.4f} / {ranks[1]['d']['ms'][nbytes]:.4f} ms a call "
            f"(ranks 0 / 1; one ladder hop and the total's all-reduce, "
            f"gloo through the host on one card, not the NDR link); "
            f"GpuCostModel's scan_time((2,), {int(nbytes)}) on the NDR "
            f"link, its link term alone (alpha has no data-sheet figure): "
            f"{link.scan_time((2,), int(nbytes)) * 1e3:.6f} ms ({smi})")
    log(f"[ep] 17(d), the ladder's checks and times, took "
        f"{r0['d']['s']:.2f} / {ranks[1]['d']['s']:.2f}s (ranks 0 / 1)")
    b = r0["b"]
    slots = sorted({tuple(s) for k, _, s, _ in b["collectives"]
                    if k == "all-to-all"})
    log(f"[ep] {ARCH} x {n} layers f32 ({GRAD_ROWS}x{GRAD_SEQ}, a row a "
        f"rank) on the (2, 1, 1) mesh, {b['experts_local']} of "
        f"{get_config(ARCH).n_experts} experts a rank: loss "
        f"{b['loss']:.6f} vs unsharded on the CPU (plain versions) "
        f"{b['plain_loss']:.6f}, every gradient within {b['worst']:.3e} x "
        f"its max|g| (bound {GRAD_TOL}; batch {b['attempts']} of "
        f"{TP_TRIES}); launches "
        f"{dict((k, v) for k, v in b['counts'].items() if v)}, local "
        f"shapes {b['shapes']}; {len(b['collectives'])} collectives, of "
        f"them {6 * n} all-to-alls over expert {slots}, no all-gather "
        f"over expert; {b['split_s']:.2f}s")
    bs = r0["b_serve"]
    steady = bs["step_ms"][1:]
    log(f"[ep] {ARCH} x {n} layers f32 served, prompts {bs['lens']} (a "
        f"rank each) into caches of {SPLIT_MAX_LEN}, {EP_STEPS} decode "
        f"steps: every call's logits within {max(bs['logit_errs']):.3e} x "
        f"max|logit| of the unsharded LM on the CPU (bound {LOGIT_TOL}), "
        f"greedy tokens equal, the gathered cache within "
        f"{bs['cache_err']:.3e}; launches "
        f"{dict((k, v) for k, v in bs['counts'].items() if v)} a rank; "
        f"prefill {bs['prefill_s']:.3f} s, decode "
        f"{sum(steady) / len(steady):.1f} ms a step")
    tokens = TRAIN_SHARDS * TRAIN_ROWS * TRAIN_SEQ
    for r in c:
        steady = r["dts"][1:] or r["dts"]
        r["mean_dt"] = sum(steady) / len(steady)
    log(f"[ep] {ARCH} full width and depth bf16 on the (2, 1, 1) mesh, "
        f"{MESH_STEPS} steps on the (1, 1) run's routing (its own would "
        f"have turned {c[0]['turned'][0]} / {c[1]['turned'][0]} of "
        f"{c[0]['turned'][1]} tokens' experts, ranks 0 / 1): losses "
        f"{c[0]['losses']} vs the (1, 1) run's "
        f"{mesh_run['losses']} (bound {TP_LOSS_RTOL} relative), gradient "
        f"norms {c[0]['grad_norms']} vs {mesh_run['grad_norms']} (bound "
        f"{TP_GNORM_RTOL} relative); {c[0]['experts_local']} experts a "
        f"rank; step time {c[0]['mean_dt'] * 1e3:.1f} / "
        f"{c[1]['mean_dt'] * 1e3:.1f} ms (ranks 0 / 1, steps 1-"
        f"{MESH_STEPS - 1}), {tokens / c[0]['mean_dt']:.0f} tokens/s, peak "
        f"{c[0]['peak_bytes']:,} / {c[1]['peak_bytes']:,} bytes "
        f"({c[0]['peak_bytes'] / 1e9:.2f} / {c[1]['peak_bytes'] / 1e9:.2f} "
        f"GB), weights {c[0]['local_bytes'] / 1e9:.3f} GB a rank; launches "
        f"a step {c[0]['counts'][-1]}, local shapes {c[0]['shapes']}; "
        f"15c(c)'s (1, 2) mesh beside it: {tp_run['mean_dt'] * 1e3:.1f} ms "
        f"a step, {tokens / tp_run['mean_dt']:.0f} tokens/s, peak "
        f"{tp_run['peak_bytes'] / 1e9:.2f} GB; gloo up in "
        f"{r0['init_s']:.2f}s, the ranks {wall:.1f}s ({smi})")
    for r, res in enumerate(c):
        prof = res["profile"]
        log(f"[ep] rank {r}, one loss and gradients under torch.profiler: "
            f"{prof['wall_ms']:.1f} ms, of it {prof['gloo_ms']:.1f} ms of "
            f"host time in {prof['gloo_calls']} gloo collectives "
            f"({gloo_kinds(prof)}), device busy "
            f"{prof['busy_ms']:.1f} ms; 15c(c)'s rank 0: "
            f"{tp_run['profile']['wall_ms']:.1f} ms, gloo "
            f"{tp_run['profile']['gloo_ms']:.1f} ms "
            f"({gloo_kinds(tp_run['profile'])}), busy "
            f"{tp_run['profile']['busy_ms']:.1f} ms ({smi})")
    launches = {name: sum(s[name] for s in c[0]["counts"])
                for name in c[0]["counts"][0]}
    shutil.rmtree(EP_OUT, ignore_errors=True)
    MESH_ROUTES.unlink(missing_ok=True)
    return launches


def start_dryrun():
    """15b's dry run started in a child (python -m
    repro_torch.launch.dryrun); returns (process, start time, env)."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = {**os.environ,
           "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    cell = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            ARCH, "--shape", "train_4k", "--mesh", "single", "--out",
            str(DRYRUN_DIR)]
    proc = subprocess.Popen(cell, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    atexit.register(proc.kill)      # if a phase fails before it is read
    return proc, time.perf_counter(), env


def phase_dryrun(proc, t0, env):
    """15b: the dry run's CLI (started by ``start_dryrun``) and its
    summary in subprocesses."""
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
    if proc.returncode:
        fail(f"dryrun: exited {proc.returncode}: {stdout[-2000:]} "
             f"{stderr[-2000:]}")
    summary = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.summarize", "--dir",
         str(DRYRUN_DIR)], capture_output=True, text=True, env=env,
        timeout=120)
    if summary.returncode:
        fail(f"summarize: exited {summary.returncode}: "
             f"{summary.stderr[-2000:]}")
    rec = json.loads((DRYRUN_DIR /
                      f"{ARCH}__train_4k__single.json").read_text())
    want = plan_state_bytes(get_config(ARCH))
    if rec["memory"]["state_bytes"] != want or rec["n_devices"] != 256:
        fail(f"dryrun: state bytes {rec['memory']['state_bytes']} on "
             f"{rec['n_devices']} ranks, the plan's {want} on 256")
    r = rec["roofline"]
    for line in summary.stdout.strip().splitlines()[2:5]:
        log(f"[dryrun] {line}")
    log(f"[dryrun] {ARCH} train_4k on a fake world of 256 ranks: state "
        f"{rec['memory']['state_bytes']:,} bytes a rank (= the plan's), "
        f"{rec['cost']['flops']:.4e} FLOPs a rank, "
        f"{rec['collectives']['total_count']} collectives "
        f"({rec['collectives']['total_bytes']:,} bytes on the wire), "
        f"useful {r['useful_compute_ratio']:.4f}, roofline "
        f"{r['roofline_fraction']:.4f} (H100 SXM data-sheet figures); "
        f"done within {time.perf_counter() - t0:.1f}s of its start, "
        f"summarize included")
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)


def phase_train(smi: str, dev):
    """Phase 14; returns the backward kernels' records and the training
    path's launch counts (14b)."""
    records = phase_kernels_bwd(dev, smi)
    torch.cuda.empty_cache()
    granite = phase_granite_train(dev, smi)
    torch.cuda.empty_cache()
    falcon = phase_falcon_train(dev, smi)
    records[0]["launches"] = granite["flash_attention_bwd"]
    records[0]["tc_launches"] = granite["flash_attention_bwd_tc"]
    records[1]["launches"] = falcon["mamba_scan_bwd"]
    records[1]["falcon_train_launches"] = falcon["mamba_scan_bwd"]
    torch.cuda.empty_cache()
    phase_train_vs_plain(dev)
    torch.cuda.empty_cache()
    phase_restart(smi)
    torch.cuda.empty_cache()
    return records, granite, falcon


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # float32 products in full float32 on the card (TF32 off), as the plain
    # versions and the CPU compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    global T_START
    T_START = t = time.perf_counter()

    phase_build()
    t = mark("1", t)
    # 15b's and 17's dry runs: CPU-only children, on the host from here on
    dryrun, ep_dryrun_proc = start_dryrun(), start_ep_dryrun()

    # phase 3 first: phase 2 checks the kernels on the inputs it lowered
    results, launches, (slot, works, powers, cfg, scale) = phase_sweep(
        scenario())
    tensors = to_tensors(slot, works, powers, scale, device=dev)
    del slot, works
    t = mark("3", t)
    kernels = phase_kernels(dev, tensors[0], tensors[1], cfg)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    kernels += phase_kernels_lm(dev)
    t = mark("2", t)
    engine_s = phase_repeat(results, tensors, cfg)
    phase_profile(tensors, cfg, engine_s)
    del tensors, results
    torch.cuda.empty_cache()
    t = mark("3 (rerun and profile)", t)
    phase_small(dev)
    t = mark("4", t)

    lm, prompts, launches = phase_serve(dev)
    for k in kernels[2:]:
        k["launches"] = launches[k["name"]]   # flash: all on tensor cores
    phase_serve_profile(lm, prompts)
    del lm
    torch.cuda.empty_cache()
    t = mark("5", t)
    phase_serve_vs_plain(dev)
    torch.cuda.empty_cache()
    t = mark("6", t)

    mamba = phase_kernels_mamba(dev)
    t = mark("7", t)
    launches = phase_falcon_serve(dev)
    mamba["launches"] = launches["mamba_scan"]
    kernels.append(mamba)
    torch.cuda.empty_cache()
    t = mark("8", t)
    phase_falcon_vs_plain(dev)
    t = mark("9", t)
    phase_hybrid_vs_plain(dev)
    torch.cuda.empty_cache()
    t = mark("10", t)
    ev0 = phase_events(dev, smi)
    t = mark("11", t)
    launches = phase_trace_sweep(dev, smi)
    for k in kernels[:2]:
        k["trace_launches"] = launches[k["name"]]
    torch.cuda.empty_cache()
    phase_trace_replay(smi)
    phase_federation(dev, smi)
    torch.cuda.empty_cache()
    phase_dag(smi)
    t = mark("12", t)
    launches = phase_cli(ev0, smi)
    for k in kernels[:2]:
        k["cli_launches"] = launches[k["name"]]
    t = mark("13", t)
    records, granite, falcon = phase_train(smi, dev)
    for k in kernels:
        if k["name"] in granite:
            k["train_launches"] = granite[k["name"]]
    kernels[-1]["falcon_train_launches"] = falcon["mamba_scan"]
    kernels += records
    torch.cuda.empty_cache()
    t = mark("14", t)
    mesh, tp, mesh_run, tp_run = phase_mesh(smi, dryrun)
    for k in kernels:
        if k["name"] in mesh:
            k["mesh_launches"] = mesh[k["name"]]
        if k["name"] in tp:
            k["tp_launches"] = tp[k["name"]]
    torch.cuda.empty_cache()
    t = mark("15", t)
    split = phase_serve_split(smi, dev)
    for k in kernels:
        if k["name"] in split:
            k["split_serve_launches"] = split[k["name"]]
    torch.cuda.empty_cache()
    t = mark("16", t)
    ep = phase_ep(smi, mesh_run, tp_run, ep_dryrun_proc)
    for k in kernels:
        if k["name"] in ep:
            k["ep_launches"] = ep[k["name"]]
    t = mark("17", t)

    log(f"[done] all phases passed in {time.perf_counter() - T_START:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [
        {k: rec[k] for k in keys} | {k: v for k, v in rec.items()
                                     if k not in keys}
        for rec in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [MESH_CHILD]:
        sys.exit(mesh_child(sys.argv[2], sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == [TP_CHILD]:
        sys.exit(tp_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                          sys.argv[5], sys.argv[6]))
    if sys.argv[1:2] == [SPLIT_CHILD]:
        sys.exit(split_child(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4], sys.argv[5], sys.argv[6]))
    if sys.argv[1:2] == [EP_DRY_CHILD]:
        sys.exit(ep_dryrun_child(sys.argv[2]))
    if sys.argv[1:2] == [EP_CHILD]:
        sys.exit(ep_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                          sys.argv[5], sys.argv[6]))
    sys.exit(main())
