#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration names its runner
(``runners/<runner>.py``), which sets up, runs the measured window and
checks the window's answers against the plain reference. With ``--trace 0``
the line's metrics are the cell's end-to-end metrics; with ``--trace 1``
the window runs under a device-only profiler and the metrics are the cell's
per-layer metrics, each read by ``metrics/<metric>.py``.

The run refuses (exit 2, no result) without as many CUDA devices as the
cell asks for, and fails (exit 3, no result) if ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the result line is
built, the metric readers' imports included. The numbers compared with the reference, each with its limit, are
the last lines on standard error and the last key of the result line, which
is the last line on standard output.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402  (the clock starts before any import)
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(name for name in names
                  if name.split(".", 1)[0] in FORBIDDEN)


def _number(x: float) -> float:
    """JSON has no infinity: a gap that is infinite reads as the largest
    double."""
    return x if math.isfinite(x) else sys.float_info.max


def result_line(cell, outcome, trace: bool, bench_dir=None) -> dict:
    """The result's JSON object, its keys in the contract's order, the
    compared numbers last."""
    from portbench import devtrace
    from portbench.manifest import BENCH_DIR, load_module
    bench_dir = BENCH_DIR if bench_dir is None else bench_dir
    metrics = {}
    if trace:
        for entry in cell.per_layer:
            reader = load_module("metrics", entry["name"], bench_dir)
            value = reader.read(outcome.trace)
            if value is not None:
                metrics[entry["name"]] = {"value": float(value),
                                          "unit": entry["unit"]}
    else:
        for entry in cell.end_to_end:
            value = outcome.values.get(entry["name"])
            if value is not None:
                metrics[entry["name"]] = {"value": float(value),
                                          "unit": entry["unit"]}
    device = dict(outcome.device)
    line = {"correct": bool(outcome.correct),
            "attempted": int(outcome.attempted),
            "failed": int(outcome.failed),
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": devtrace.top_ops(outcome.trace),
                             "idle_gaps": devtrace.idle_gaps(outcome.trace)}
    line["checks"] = {name: {"value": _number(value), "limit": limit}
                      for name, (value, limit) in outcome.checks.items()}
    return line


def emit(cell, outcome, trace: bool, bench_dir=None) -> int:
    """Print the run's result: the compared numbers on standard error, then
    the result line on standard output; 0. Where ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` is loaded by then, the metric readers included,
    print no result and return 3."""
    line = result_line(cell, outcome, trace, bench_dir)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: the port must not load "
              f"jax, jaxlib, flax or the JAX package", file=sys.stderr)
        return 3
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             device: str, started: float, manifest=None, bench_dir=None):
    """``(cell, outcome)`` of one run of the cell ``name`` on ``device``
    (the tests run it on "cpu" with a manifest of their own)."""
    from portbench.manifest import BENCH_DIR, load_cell, load_module
    bench_dir = BENCH_DIR if bench_dir is None else bench_dir
    cell = load_cell(name, manifest, bench_dir)
    runner = load_module("runners", cell.config["runner"], bench_dir)
    return cell, runner.run(cell, seed=seed, seconds=seconds, trace=trace,
                            device=device, started=started)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.seed < 0:
        print(f"portbench: --seed must be a whole number >= 0, got "
              f"{args.seed}", file=sys.stderr)
        return 2
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from portbench.manifest import load_cell, load_manifest
    chips = load_cell(args.workload, load_manifest()).chips

    import torch
    print(f"portbench: torch imported at {time.perf_counter() - STARTED:.3f}"
          f"s", file=sys.stderr, flush=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {args.workload} needs {chips} CUDA "
              f"device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count() = "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    cell, outcome = run_cell(args.workload, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             device="cuda", started=STARTED)
    return emit(cell, outcome, bool(args.trace))

if __name__ == "__main__":
    sys.exit(main())
