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
             loop on two rows each, and timed each with its bound. The MoE
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

The line before the last is the card's name and power limit from
nvidia-smi, the one before it the kernels' JSON record; the last line is the
JSON result. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import lab  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.lab.backends import (  # noqa: E402
    assemble_events_result,
    build_events_runtime,
)
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


def ordered_loop(idx_row, w_row, e):
    """The FIFO prefix of one row as simulate_scalar sums it: acc[d] += w in
    token order, in Python floats (IEEE float64). Returns (prefix, fill)."""
    acc = [0.0] * e
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
    last-token check."""
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
        # (b) router logits
        lc = lc.cpu()
        r_err = (lc - lh).abs().max().item() / lh.abs().max().item()
        if not r_err <= LOGIT_TOL:
            fail(f"layer {layer}: router logits differ by {r_err:.3e} x max")
        # (c) routing across devices
        same = [all(torch.equal(getattr(rc, f)[gi].cpu(), getattr(rh, f)[gi])
                    for f in fields) for gi in range(len(lens))]
        top = torch.topk(lh, k + 1, dim=-1)
        gaps = (top.values[..., :-1] - top.values[..., 1:]).min(-1).values
        flipped = (torch.topk(lc, k, dim=-1).indices
                   != top.indices[..., :k]).any(-1)
        for gi in range(len(lens)):
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
            f"{r_err:.2e} x max; prompts routed alike on both devices: "
            f"{sum(same)}/{len(lens)}")
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
    phase_events(dev, smi)

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
