#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   — compile every kernel in src/repro_torch/kernels/csrc (one nvcc
             per source, all at once) into build/repro_torch_kernels.
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
             under torch.profiler gives device time by kernel.
4. small   — a small faulted run twice on the card: bit-identical, and equal
             to ``simulate_scalar`` per seed at rtol 1e-6.
5. serve   — the second path: granite-moe-1b-a400m at full width (24
             layers, bf16 compute, f32 params, bf16 KV cache, weights from
             ``LM.init`` with a CUDA generator seeded 0) served through
             ``repro_torch.launch.serve.serve``: 2 replicas on one
             ReplicaScheduler, 8 slots each, max_len 4096, 32 requests with
             prompt lengths uniform in 256..2048, 64 new tokens each, greedy.
             The launch counters are zeroed just before and read just after
             and must equal 24 flash launches per prefill call, every one on
             the tensor cores, and 24 dispatch-positions launches (one per
             MoE layer, all 8 priority levels) per prefill call and decode
             step;
             a second run must repeat every token; one more short run under
             torch.profiler gives device time by kernel, flash's included.
6. serve-vs-plain — the same config with 2 layers in float32, the same
             weights on the card and on the CPU (which runs the plain
             versions): 4 right-padded prompts prefilled on each; last-token
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
             uniform in 256..2048, 32 new tokens each, greedy. Launch
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
             work mean 6, horizon 50, PSTS (floor 0.1, trigger period 1),
             about 29,000 tasks a seed. ``lab.sweep`` with backend "auto"
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
       0-15 over the bundled Google excerpt parsed with
       eviction_mode="end" and rate-scaled 966x (``TraceRef(scale=966)``,
       ~1.64 M tasks a seed in the first 400 s) on the 12,500-node cluster,
       PSTS with fifo_dispatch. It must run on ``batched``, flag the
       trace's priorities and eviction outcomes as ignored, launch the scan
       and dispatch kernels (counters zeroed just before, read just
       after); seeds 0 and 15 equal ``simulate_scalar`` at rtol 1e-6, and
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
       preset's shape at 4 x 256 nodes, horizon 50 (member 0 at 120%
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

The line before the last is the card's name and power limit from
nvidia-smi, the one before it the kernels' JSON record; the last line is the
JSON result. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import time
import urllib.request
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import lab  # noqa: E402
from repro_torch import obs as obs_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.lab.backends import (  # noqa: E402
    assemble_events_result,
    build_events_runtime,
)
from repro_torch.lab import backends as lab_backends  # noqa: E402
from repro_torch.lab import cli as lab_cli  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.obs import parse_openmetrics  # noqa: E402
from repro_torch.sched import moe_dispatch  # noqa: E402
from repro_torch.serve import Engine, GenRequest  # noqa: E402
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
SERVE_NEW = 64
PROMPT_LO, PROMPT_HI = 256, 2048
# the third path: falcon-mamba-7b at full width
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "jamba-v0.1-52b"
SSM_REQUESTS = 16
SSM_SLOTS = 4
SSM_NEW = 32
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
EV_HORIZON = 50.0
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
TRACE_HORIZON = 400.0
TRACE_SEEDS = 16
TRACE_SAMPLED = (0, 15)
TRACE_IGNORED = ("workload trace priorities",
                 "workload trace eviction outcomes (ends_evicted)")
# examples/trace_replay.py's cluster: 4 machine classes x 4 nodes
REPLAY_POWERS = (1.0,) * 4 + (1.25,) * 4 + (1.75,) * 4 + (2.0,) * 4
REPLAY_ATTRS = {"machine_class": (0.0,) * 4 + (1.0,) * 4 + (2.0,) * 4
                + (3.0,) * 4}
FED_MEMBERS = 8
GEO_NODES = 256
GEO_HORIZON = 50.0
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
        info = [ln.strip() for ln in r["ptxas"].splitlines()
                if "Used" in ln or "spill" in ln]
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


def phase_sweep(base, cfg, powers, scale):
    """The main path, driven through the lab entry point."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = lab.sweep(base=base, grid={"seed": range(SEEDS)},
                        fifo_dispatch=True)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[sweep] {SEEDS} seeds x {N_NODES} nodes x {cfg.n_slots} slots: "
        f"wall {wall:.2f}s (workload generation included), peak device "
        f"memory {peak / 2**30:.2f} GiB, launches {launches}")
    if [r.backend for r in results] != ["batched"] * SEEDS:
        fail("the sweep did not auto-dispatch to the batched backend")
    want = {"prefix_scan": 1 + cfg.n_slots,
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
    return results, launches


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
    kernels whose names hold a string of ``watch`` wherever they rank."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
        return
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
    want = {"prefix_scan": 0, "dispatch_work_prefix": 0, "mamba_scan": 0,
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
        t0 = time.perf_counter()
        logit_host, _ = host.prefill(host.init_cache(4, 512), toks, lens)
        t_host = time.perf_counter() - t0
        on_host = list(calls)
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
        f"on the card, {t_host:.3f}s on the CPU")


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
    want = {"prefix_scan": 0, "dispatch_work_prefix": 0,
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
    want = {"prefix_scan": 0, "dispatch_work_prefix": 0,
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
            # the horizon keeps the first 400 s of the scaled trace on
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
    want = {"prefix_scan": 1 + cfg.n_slots,
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
    want = {"prefix_scan": 1 + T, "dispatch_work_prefix": 1 + T,
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
    t_start = time.perf_counter()

    phase_build()

    base = scenario()
    scs = lab.expand_grid(base, {"seed": range(SEEDS)})
    backend = lab.get_backend("batched")
    t0 = time.perf_counter()
    slot, works, powers, cfg, scale = backend.compile(
        scs, backend.default_dt, fifo_dispatch=True)
    tensors = to_tensors(slot, works, powers, scale, device=dev)
    log(f"[data] slot/works {slot.shape}, sum(powers)={powers.sum():.0f}, "
        f"T={cfg.n_slots}, n={cfg.n_nodes}, lowered in "
        f"{time.perf_counter() - t0:.1f}s")
    del slot, works

    kernels = phase_kernels(dev, tensors[0], tensors[1], cfg)
    kernels += phase_kernels_lm(dev)
    results, launches = phase_sweep(base, cfg, powers, scale)
    for k in kernels[:2]:
        k["launches"] = launches[k["name"]]
    engine_s = phase_repeat(results, tensors, cfg)
    phase_profile(tensors, cfg, engine_s)
    del tensors, results
    torch.cuda.empty_cache()
    phase_small(dev)

    lm, prompts, launches = phase_serve(dev)
    for k in kernels[2:]:
        k["launches"] = launches[k["name"]]   # flash: all on tensor cores
    phase_serve_profile(lm, prompts)
    del lm
    torch.cuda.empty_cache()
    phase_serve_vs_plain(dev)
    torch.cuda.empty_cache()

    mamba = phase_kernels_mamba(dev)
    launches = phase_falcon_serve(dev)
    mamba["launches"] = launches["mamba_scan"]
    kernels.append(mamba)
    torch.cuda.empty_cache()
    phase_falcon_vs_plain(dev)
    phase_hybrid_vs_plain(dev)
    torch.cuda.empty_cache()
    ev0 = phase_events(dev, smi)
    t12 = time.perf_counter()
    launches = phase_trace_sweep(dev, smi)
    for k in kernels[:2]:
        k["trace_launches"] = launches[k["name"]]
    torch.cuda.empty_cache()
    phase_trace_replay(smi)
    phase_federation(dev, smi)
    torch.cuda.empty_cache()
    phase_dag(smi)
    log(f"[phase 12] {time.perf_counter() - t12:.1f}s")
    t13 = time.perf_counter()
    launches = phase_cli(ev0, smi)
    for k in kernels[:2]:
        k["cli_launches"] = launches[k["name"]]
    log(f"[phase 13] {time.perf_counter() - t13:.1f}s")

    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
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
    sys.exit(main())
