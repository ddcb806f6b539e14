"""Roofline analysis of a dry-run record (``launch.dryrun``).

Three terms per (arch x shape x mesh), in seconds per step on one NVIDIA
H100 SXM of the mesh:

  compute    = FLOPs / peak FLOP/s                   (one rank's step)
  memory     = bytes / HBM bandwidth
  collective = collective bytes on the wire / link bandwidth

``HW`` holds NVIDIA's data-sheet figures: H100 SXM, 989 TFLOP/s dense
bf16 (no sparsity) and 3.35 TB/s of HBM3; and one ConnectX-7 InfiniBand
NDR port per card, 400 Gb/s = 50 GB/s each way (the DGX H100 data sheet's
eight 400 Gb/s ports for eight cards). The links are InfiniBand's because
at 256 or 512 ranks every mesh axis spans nodes of eight cards: ``model``
is 16 consecutive ranks, ``data`` strides over 16 nodes.

The dry run counts a step's FLOPs exactly (``torch.utils.flop_counter``
on meta tensors) and records each collective the step issues (kind,
result shape, dtype, group size); ``collective_stats`` prices them with
the ring conventions of the JAX package's HLO parser. MODEL_FLOPS =
6·N_active·tokens (train) or 2·N_active·tokens (inference) gives the
useful-compute ratio that catches remat/redundancy waste.
"""

from __future__ import annotations

from ..core.cost_model import NDR_LINK_BW

__all__ = ["HW", "collective_stats", "model_flops", "roofline_report"]

HW = {
    "peak_flops": 989e12,   # bf16 dense, H100 SXM data sheet
    "hbm_bw": 3.35e12,      # bytes/s, H100 SXM data sheet
    "ib_bw": NDR_LINK_BW,   # bytes/s each way, one ConnectX-7 NDR port
}

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")


def collective_stats(collectives: list[dict]) -> dict:
    """Per-device bytes moved on the wire, per collective kind, of the
    collectives a step issued: dicts of ``kind`` (one of ``COLL_KINDS``),
    ``bytes`` (of the result) and ``group`` (its size).

    Convention (ring algorithms, g = group size):
      all-gather        : receives (g-1)/g of the result       ~ result
      reduce-scatter    : sends (g-1)/g of the input = (g-1) x result
      all-reduce        : RS + AG on the operand                ~ 2 x result
      all-to-all        : re-sends (g-1)/g of the buffer        ~ result
      collective-permute: result bytes
    """
    by_kind: dict[str, dict] = {k: {"count": 0, "bytes": 0}
                                for k in COLL_KINDS}
    for c in collectives:
        kind, res, g = c["kind"], c["bytes"], max(int(c["group"]), 1)
        if kind == "all-gather":
            moved = res * (g - 1) / g
        elif kind == "reduce-scatter":
            moved = res * (g - 1)
        elif kind == "all-reduce":
            moved = 2 * res * (g - 1) / g
        elif kind == "all-to-all":
            moved = res * (g - 1) / g
        else:  # collective-permute
            moved = res
        by_kind[kind]["count"] += 1
        by_kind[kind]["bytes"] += int(moved)
    total_bytes = sum(v["bytes"] for v in by_kind.values())
    total_count = sum(v["count"] for v in by_kind.values())
    return {"total_bytes": total_bytes, "total_count": total_count,
            "by_kind": {k: v for k, v in by_kind.items() if v["count"]}}


def model_flops(cfg, shape) -> float:
    """6·N_active·D for training, 2·N_active·D for inference forward."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.prefix_len:
            tokens += shape.global_batch * cfg.prefix_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline_report(record: dict, cfg, shape) -> dict:
    flops_dev = float(record["cost"]["flops"] or 0.0)
    bytes_dev = float(record["cost"]["bytes_accessed"] or 0.0)
    coll_dev = float(record["collectives"]["total_bytes"])
    n_dev = record["n_devices"]
    compute_s = flops_dev / HW["peak_flops"]
    memory_s = bytes_dev / HW["hbm_bw"]
    coll_s = coll_dev / HW["ib_bw"]
    mf = model_flops(cfg, shape)
    useful = mf / max(flops_dev * n_dev, 1.0)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    # memory-bound cells (decode): efficiency against the bandwidth roofline
    # — the state (params + cache) must be read at least once per step
    min_bytes = float(record["memory"]["args_bytes"])
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": mf,
        "useful_compute_ratio": useful,
        # fraction of the roofline the useful compute achieves if the step
        # ran exactly at the dominant-term time
        "roofline_fraction": (mf / n_dev / HW["peak_flops"]) / max(bound,
                                                                   1e-12),
        # bandwidth roofline: minimum necessary traffic / modeled traffic
        "bandwidth_fraction": min_bytes / max(bytes_dev, 1.0),
    }
