"""Aggregate dry-run cell records (``launch.dryrun``) into the roofline
table.

Usage: python -m repro_torch.launch.summarize \
           [--dir experiments/dryrun] [--mesh 16x16]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["load_records", "table", "pick_hillclimb", "main"]


def load_records(directory: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def table(recs: list[dict], mesh: str | None = None) -> str:
    rows = []
    hdr = ("| arch | shape | mesh | state GiB/dev | t_compute | t_mem | "
           "t_coll | dominant | useful | roofline | bw-frac |")
    sep = "|" + "---|" * 11
    rows.append(hdr)
    rows.append(sep)
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if mesh and r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['memory']['args_bytes']/2**30:.2f} "
            f"| {rf['compute_s']:.4f} | {rf['memory_s']:.4f} "
            f"| {rf['collective_s']:.4f} | {rf['dominant']} "
            f"| {rf['useful_compute_ratio']:.2f} "
            f"| {rf['roofline_fraction']:.3f} "
            f"| {rf['bandwidth_fraction']:.3f} |")
    return "\n".join(rows)


def pick_hillclimb(recs: list[dict]) -> dict:
    """Worst roofline fraction, most collective-bound, and the paper-
    representative MoE cell (single-pod mesh)."""
    single = [r for r in recs if r["mesh"] == "16x16"]
    worst = min(single, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(single, key=lambda r: (r["roofline"]["collective_s"]
                                      / max(sum([r["roofline"]["compute_s"],
                                                 r["roofline"]["memory_s"],
                                                 r["roofline"]["collective_s"]
                                                 ]), 1e-12)))
    moe = [r for r in single
           if r["arch"] in ("granite-moe-1b-a400m", "grok-1-314b",
                            "jamba-v0.1-52b") and r["kind"] == "train"]
    rep = max(moe, key=lambda r: r["roofline"]["collective_s"]) if moe else \
        None
    return {"worst_roofline": f"{worst['arch']}/{worst['shape']}",
            "most_collective": f"{coll['arch']}/{coll['shape']}",
            "paper_representative": (f"{rep['arch']}/{rep['shape']}"
                                     if rep else "n/a")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(f"{len(recs)} cells\n")
    print(table(recs, args.mesh))
    print("\nhillclimb candidates:", json.dumps(pick_hillclimb(recs),
                                                indent=1))


if __name__ == "__main__":
    main()
