"""Probe: what torch.profiler costs on the batched engine's full-width run,
with the host's ops traced beside the device and with the device alone.

    python experiments/torch_profiler_cost_probe.py

Builds the kernels, lowers ``chip_smoke.py``'s sweep cell (128 seeds x
12,500 nodes x 200 slots), runs the engine once to warm up and once timed,
then runs it under ``torch.profiler`` twice: with CPU and CUDA activity,
then with CUDA alone. For each it prints the seconds of the profiled run
(its exit included), of ``key_averages()``, and the device time, kernel
kinds and launches that ``chip_smoke.device_time_table`` would read; then
whether both give the same kernels. Needs the card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def kernel_rows(prof) -> dict:
    rows = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows[evt.key] = (dev_us, evt.count)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smoke.phase_build()
    dev = torch.device("cuda", 0)
    scs = smoke.lab.expand_grid(smoke.scenario(),
                                {"seed": range(smoke.SEEDS)})
    backend = smoke.lab.get_backend("batched")
    t0 = time.perf_counter()
    slot, works, powers, cfg, scale = backend.compile(
        scs, backend.default_dt, fifo_dispatch=True)
    tensors = smoke.to_tensors(slot, works, powers, scale, device=dev)
    print(f"lowered in {time.perf_counter() - t0:.2f}s", flush=True)

    def run():
        smoke._simulate_batch_torch(*tensors, cfg)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    print(f"engine {time.perf_counter() - t0:.2f}s", flush=True)
    found = {}
    for name, acts in (("CPU+CUDA", [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]),
                       ("CUDA", [ProfilerActivity.CUDA])):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            run()
        t1 = time.perf_counter()
        rows = kernel_rows(prof)
        t2 = time.perf_counter()
        print(f"{name}: profiled run {t1 - t0:.2f}s, key_averages "
              f"{t2 - t1:.2f}s, {len(rows)} kernels, "
              f"{sum(v[1] for v in rows.values())} launches, device "
              f"{sum(v[0] for v in rows.values()) / 1e6:.4f}s", flush=True)
        found[name] = rows
    both, alone = found.values()
    print(f"kernels only with the host traced: {sorted(set(both) - set(alone))}"
          f"; only without: {sorted(set(alone) - set(both))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
