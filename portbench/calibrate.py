#!/usr/bin/env python3
"""The readings that a cell's limit is set from, on the card at the cell's
own size: the program's compared number on each seed, and the control's
(the plain reference in float32, put in the program's place).

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the two sweeps a run draws, each run once
through the engine's entry, the scenarios a run samples, and
``check_window``'s number for the program and for the control. One JSON
line a seed on standard output. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def control_answers(ref, config, powers, sweeps, calls, picks):
    """The window's answers as the float32 reference gives them: each
    picked scenario's six metrics, and every scenario's completed count
    (the reference's count of its tasks)."""
    answers = []
    for which in calls:
        tasks = sweeps[which][2]
        fields = {k: np.full(tasks.shape, np.nan) for k in ref.FIELDS}
        fields["completed"] = tasks.astype(np.float64)
        answers.append(SimpleNamespace(**fields))
    for i, row in picks:
        slot, works, _ = sweeps[calls[i]]
        got = ref.simulate(slot[row], works[row], powers, config,
                           dtype=np.float32)
        for k in ref.FIELDS:
            getattr(answers[i], k)[row] = got[k]
    return answers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import gen
    from portbench.manifest import load_cell, load_module
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.runtime import vector_backend

    cell = load_cell(args.workload)
    runner = load_module("runners", cell.config["runner"])
    ref = load_module("references", cell.config["reference"])
    config = cell.config
    powers = gen.node_powers(config)
    cfg = runner.vector_config(config)
    for seed in args.seeds:
        t0 = time.perf_counter()
        sweeps = gen.draw_sweeps(cell.traffic, config, powers, seed, 2,
                                 "cuda")
        calls = [0, 1]
        answers = [vector_backend.simulate_batch(s[0], s[1], powers, cfg)
                   for s in sweeps]
        t1 = time.perf_counter()
        picks = runner.sample_scenarios(seed, calls, sweeps)
        program, failed = runner.check_window(config, powers, sweeps, calls,
                                              answers, picks)
        t2 = time.perf_counter()
        control, control_failed = runner.check_window(
            config, powers, sweeps, calls,
            control_answers(ref, config, powers, sweeps, calls, picks),
            picks)
        fires = [float(answers[i].trigger_fires[row]) for i, row in picks]
        print(json.dumps({
            "cell": args.workload, "seed": seed, "program": program,
            "program_failed": failed, "control": control,
            "control_failed": control_failed, "picks": len(picks),
            "widths": [int(s[0].shape[1]) for s in sweeps],
            "tasks": [int(s[2].sum()) for s in sweeps],
            "picked_fires": fires,
            "engine_s": t1 - t0, "reference_s": t2 - t1,
            "control_s": time.perf_counter() - t2}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
