"""Probe: the batched engine's own spans (``simulate_batch(...,
tracer=)``) against a device trace of the same sweeps, in one cell of the
benchmark.

    PYTHONPATH=src:. python experiments/trace_sweep.py --workload <cell> \\
        [--seed N] [--seconds S] [--repeats R] [--out chiprun_out/x.json]

Draws the cell's two sweeps as ``portbench/runners/sweep.py`` does, warms
the engine, then:

1. the tracing cost: ``R`` sweeps without a tracer and ``R`` with one, in
   turns (plain, traced, traced, plain, ...), no profiler; each traced
   answer held bit for bit against the plain one of the same sweep;
2. a window of whole sweeps, alternating, for ``S`` seconds, under a
   device-only ``torch.profiler`` as a ``--trace 1`` run of the benchmark
   traces it, first without the engine's tracer and then with it; from
   both, the device's idle by gap length; from the traced one, each slot
   phase's device time, the idle split by the engine's spans (in the slot
   loop, in the rest of a call, outside every call) against
   ``devtrace.idle_gaps``' labels, and the share of swept elements that
   are real tasks.

Prints one JSON object; ``--out`` also writes the engine lane's Chrome
trace of the window (open it in https://ui.perfetto.dev). Needs the card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import devtrace, gen  # noqa: E402
from portbench.manifest import load_cell, load_module  # noqa: E402

FIELDS = ("mean_response", "p99_response", "makespan", "trigger_fires",
          "moved_units", "completed")


def overlap(intervals, spans) -> float:
    """Microseconds that the sorted, disjoint ``intervals`` share with the
    sorted, disjoint ``spans`` (both ``(start, end)``)."""
    total, j = 0.0, 0
    for lo, hi in intervals:
        while j < len(spans) and spans[j][1] <= lo:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < hi:
            total += min(hi, spans[k][1]) - max(lo, spans[k][0])
            k += 1
    return total


def labelled_idle(trace: devtrace.DeviceTrace, lo: float, hi: float):
    """The device's idle intervals within [lo, hi] (us), sorted, each with
    the label ``devtrace.idle_gaps`` gives a gap: ``(start, end, label)``;
    the window's edges read "window edge"."""
    events = sorted(trace.kernels + trace.copies, key=lambda ev: ev[1])
    out, end_name, end_at = [], None, None
    for name, start, end in events:
        if end_at is None:
            if start > lo:
                out.append((lo, min(start, hi), "window edge"))
        elif start > end_at:
            if name.startswith("Memcpy HtoD"):
                what = "to_tensors"
            elif end_name.startswith("Memcpy DtoH"):
                what = "results, next call"
            else:
                what = "slot loop launches"
            a, b = max(end_at, lo), min(start, hi)
            if b > a:
                out.append((a, b, what))
        if end_at is None or end > end_at:
            end_name, end_at = name, end
    if end_at is not None and end_at < hi:
        out.append((max(end_at, lo), hi, "window edge"))
    return out


def host_spans(points, leaves):
    """For each sorted point (us), the name of the leaf span that holds
    it, or "outside"; ``leaves`` are ``(start, end, name)``, sorted and
    disjoint."""
    starts = [leaf[0] for leaf in leaves]
    out = []
    for p in points:
        i = bisect.bisect_right(starts, p) - 1
        out.append(leaves[i][2] if i >= 0 and p < leaves[i][1]
                   else "outside")
    return out


def split(trace: devtrace.DeviceTrace, engine: list, window, top=10):
    """The engine readings of one traced window: ``engine`` is the tracer's
    Chrome events on the engine lane, ``window`` its ``(start, end)`` in us
    on the same clock."""
    spans = [e for e in engine if e["ph"] == "X"]
    counters = [e for e in engine if e["ph"] == "C"]

    def iv(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                      if e["name"] == name)

    def device_ms(name):
        return sum(e["args"]["device_ms"] for e in spans
                   if e["name"] == name)

    def count(name):
        return sum(e["args"][name] for e in counters if e["name"] == name)

    calls = len(iv("simulate_batch"))
    slots = len(iv("owner_search"))
    gaps = labelled_idle(trace, *window)
    idle = [(a, b) for a, b, _ in gaps]
    in_calls = overlap(idle, iv("simulate_batch"))
    in_loop = overlap(idle, iv("slot_loop"))
    leaves = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
                    if e["name"] not in ("simulate_batch", "slot_loop"))
    # idle ms by the leaf span the host was in, and by idle_gaps' label
    # against that span (each gap put down to the span at its middle)
    by_leaf = {name: overlap(idle, [(a, b) for a, b, n in leaves
                                    if n == name]) / 1e3
               for name in {leaf[2] for leaf in leaves}}
    by_leaf["outside"] = (sum(b - a for a, b in idle) - in_calls) / 1e3
    hosts = host_spans([0.5 * (a + b) for a, b, _ in gaps], leaves)
    table: dict = {}
    for (a, b, guess), host in zip(gaps, hosts):
        key = f"{guess} | {host}"
        table[key] = table.get(key, 0.0) + (b - a) / 1e3
    longest = sorted(zip(gaps, hosts), key=lambda g: g[0][0] - g[0][1])
    busy_in_calls = overlap(devtrace.merge_busy(trace.kernels + trace.copies),
                            iv("simulate_batch"))
    return {
        "calls": calls, "slots": slots,
        "owner_search_ms_per_slot": device_ms("owner_search") / slots,
        "dispatch_ms_per_slot": device_ms("dispatch") / slots,
        "trigger_service_ms_per_slot": device_ms("trigger_service") / slots,
        "sweep_passes_ms_per_sweep":
            (device_ms("tables") + device_ms("finish")) / calls,
        "to_tensors_device_ms_per_sweep": device_ms("to_tensors") / calls,
        "results_device_ms_per_sweep": device_ms("results") / calls,
        "call_device_ms_per_sweep": device_ms("simulate_batch") / calls,
        "loop_idle_ms_per_slot": in_loop / 1e3 / slots,
        "entry_idle_ms_per_sweep": (in_calls - in_loop) / 1e3 / calls,
        "outside_idle_ms_per_sweep": by_leaf["outside"] / calls,
        "idle_ms_by_span": by_leaf,
        "idle_ms_guess_vs_span": table,
        "idle_gaps_over_50us": sum(1 for a, b in idle if b - a > 50),
        "longest_gaps_guess_span_ms": [[g[2], host, (g[1] - g[0]) / 1e3]
                                       for g, host in longest[:top]],
        "slot_pass_useful_pct":
            100.0 * count("tasks") / count("elements_swept"),
        "h2d_bytes_per_sweep": count("h2d_bytes") / calls,
        "np_sum_plan_builds": count("np_sum_plan_builds"),
        "window_idle_ms_tracer_clock": sum(b - a for a, b in idle) / 1e3,
        "calls_host_ms": sum(b - a for a, b in iv("simulate_batch")) / 1e3,
        "busy_in_calls_ms": busy_in_calls / 1e3,
        "launches_per_slot": len(trace.kernels) / slots,
    }


def gap_sizes(gaps, edges=(2.0, 10.0, 50.0, 500.0)) -> dict:
    """``{bin: [count, ms]}`` of idle intervals by length in us."""
    names = [f"<{edges[0]:g}"] + [f"{a:g}-{b:g}" for a, b in
                                  zip(edges, edges[1:])] + [f">{edges[-1]:g}"]
    out = {name: [0, 0.0] for name in names}
    for gap in gaps:
        length = gap[1] - gap[0]
        name = names[bisect.bisect_right(edges, length)]
        out[name][0] += 1
        out[name][1] += length / 1e3
    return out


def timed(fn, into: list):
    """``fn``, appending each call's seconds to ``into``."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            into.append(time.perf_counter() - t0)
    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--repeats", type=int, default=6)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import PID_ENGINE, Tracer
    from repro_torch.runtime.vector_backend import _CallSpans, simulate_batch

    cell = load_cell(args.workload)
    runner = load_module("runners", cell.config["runner"])
    config, traffic = cell.config, cell.traffic
    powers = gen.node_powers(config)
    cfg = runner.vector_config(config)
    sweeps = gen.draw_sweeps(traffic, config, powers, args.seed, 2, "cuda")
    runner._warm(simulate_batch, max(sweeps, key=lambda s: s[0].shape[1]),
                 powers, cfg, None)
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"workload": args.workload, "seed": args.seed, "card": smi}

    # 1. the cost of tracing, no profiler; the answers bit for bit; the
    # host time of a recorder's making and closing
    spent = {"open": [], "close": []}
    for key, method in (("open", "__init__"), ("close", "close")):
        setattr(_CallSpans, method, timed(getattr(_CallSpans, method),
                                          spent[key]))
    times = {"plain": [], "traced": []}
    answers = {}
    for i in range(2 * args.repeats):
        kind = ("plain", "traced", "traced", "plain")[i % 4]
        which = (i // 2) % 2
        slot, works, _ = sweeps[which]
        tracer = Tracer() if kind == "traced" else None
        t0 = time.perf_counter()
        out = simulate_batch(slot, works, powers, cfg, tracer=tracer)
        times[kind].append(time.perf_counter() - t0)
        answers.setdefault((kind, which), out)
    result["bit_for_bit"] = all(
        np.array_equal(getattr(answers["traced", w], k),
                       getattr(answers["plain", w], k))
        for w in (0, 1) for k in FIELDS)
    result["sweep_s"] = times
    result["recorder_ms"] = {key: [1e3 * x for x in v]
                             for key, v in spent.items()}
    result["tracing_cost_pct"] = 100.0 * (
        statistics.median(times["traced"])
        / statistics.median(times["plain"]) - 1.0)

    # 2. a window without the engine's tracer, then one with it, each
    # under a device-only profiler as the benchmark's --trace 1 window
    for label, tracer in (("untraced", None), ("traced", Tracer())):
        clock = tracer or Tracer()
        engine = (lambda *a, tracer=tracer, **k:
                  simulate_batch(*a, tracer=tracer, **k))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            w0 = clock.wall_clock()
            calls, _, ends = runner._window(engine, sweeps, powers, cfg,
                                            args.seconds, None,
                                            torch.cuda.synchronize)
            torch.cuda.synchronize()
            w1 = clock.wall_clock()
        kernels, copies = devtrace.device_events(prof)
        trace = devtrace.DeviceTrace(
            kernels=kernels, copies=copies, window_s=ends[-1],
            sweeps=len(calls), slots=len(calls) * config["n_slots"],
            tasks=sum(int(sweeps[which][2].sum()) for which in calls))
        window = (w0 * 1e6, w1 * 1e6)
        gaps = labelled_idle(trace, *window)
        out = {"window_s": ends[-1], "window_s_tracer_clock": w1 - w0,
               "sweeps": len(calls), "busy_s": trace.busy_s,
               "device_idle_pct": 100.0 * (1.0 - trace.busy_s / ends[-1]),
               "launches_per_slot": len(kernels) / trace.slots,
               "idle_gaps": devtrace.idle_gaps(trace),
               "idle_by_gap_us": gap_sizes(gaps)}
        if tracer is not None:
            lane = [e for e in tracer.to_chrome_trace()["traceEvents"]
                    if e.get("pid") == PID_ENGINE and e["ph"] != "M"]
            out.update(split(trace, lane, window))
            loop = sorted((e["ts"], e["ts"] + e["dur"]) for e in lane
                          if e["name"] == "slot_loop")
            in_loop = [g for g, host in zip(gaps, host_spans(
                [0.5 * (a + b) for a, b, _ in gaps],
                [(a, b, "slot_loop") for a, b in loop])) if host != "outside"]
            out["loop_idle_by_gap_us"] = gap_sizes(in_loop)
            out["first_kernel_after_window_start_us"] = (
                min(ev[1] for ev in kernels + copies) - window[0])
            out["last_event_before_window_end_us"] = (
                window[1] - max(ev[2] for ev in kernels + copies))
        result[label] = out
        del prof, kernels, copies, trace, gaps
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        tracer.write_chrome_trace(args.out)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
