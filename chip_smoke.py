#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   — compile every kernel in src/repro_torch/kernels/csrc (one nvcc
             per source, all at once) into build/repro_torch_kernels.
2. kernels — each CUDA kernel against its plain PyTorch version on the card,
             at the main path's shapes and at edge shapes; times of the
             kernel, the plain version and the library yardstick.
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

The line before the last is the card's name and power limit from
nvidia-smi, the one before it the kernels' JSON record; the last line is the
JSON result. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

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
from repro_torch.kernels import _build, ops, ref  # noqa: E402
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

# NVIDIA H100 SXM data sheet: HBM3 rate and non-tensor FP64 rate (the
# kernels do float64 adds outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP64_OPS_PER_S * 1e3
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
    disp_ms = time_ms(lambda: ops.dispatch_work_prefix(wave_idx, wave_w, n),
                      10)
    disp_plain = time_ms(
        lambda: ref.dispatch_work_prefix_ref(wave_idx, wave_w, n), 3)
    n_valid = int(mask.sum())
    disp_bound, disp_by = bound_ms(B * M * (4 + 8) + n_valid * 8 + B * n * 8,
                                   n_valid)
    disp = dict(name="dispatch_work_prefix", route="cuda",
                source="src/repro_torch/kernels/csrc/psts_dispatch.cu",
                replaces="src/repro/kernels/psts_dispatch.py:98",
                max_abs_err=worst, ms=disp_ms, plain_ms=disp_plain,
                bound_ms=disp_bound, bound_by=disp_by, library_ms=None,
                shape=[B, M])
    for k in (scan, disp):
        log(f"[kernels] {k['name']} at {k['shape']}: {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, library {k['library_ms']}, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
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
            "dispatch_work_prefix": 1 + cfg.n_slots}
    if any(launches[k] <= 0 for k in launches) or launches != want:
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


def phase_profile(tensors, cfg, engine_s):
    """Where the engine's device time goes: one more full-width run under
    torch.profiler, device time by kernel, and the busy share of the
    unprofiled engine time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _simulate_batch_torch(*tensors, cfg)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, evt.count, evt.key))
    total_us = sum(r[0] for r in rows)
    if total_us <= 0:
        log("[profile] torch.profiler recorded no device time")
        return
    log(f"[profile] device kernel time {total_us / 1e6:.3f}s = "
        f"{100 * total_us / 1e6 / engine_s:.1f}% of the unprofiled engine "
        f"time {engine_s:.2f}s (the rest: device idle)")
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        log(f"[profile]   {100 * dev_us / total_us:5.1f}%  "
            f"{dev_us / 1e3:9.2f} ms  x{count:<5d} {key[:90]}")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
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
    results, launches = phase_sweep(base, cfg, powers, scale)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    engine_s = phase_repeat(results, tensors, cfg)
    phase_profile(tensors, cfg, engine_s)
    del tensors
    torch.cuda.empty_cache()
    phase_small(dev)

    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
