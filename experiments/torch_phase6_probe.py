"""Probe of the CPU reference that ``chip_smoke.py``'s phase 6 compares the
card against: does a float32 prefill on the host give the same bits in
every fresh process?

    python experiments/torch_phase6_probe.py --procs 40 \\
        --variants base,hashfirst --out phase6_probe.json

Each worker is a fresh Python process. It builds phase 6's model
(granite-moe-1b-a400m cut to 2 layers, float32, weights drawn normal from
a CPU generator at LM.init's fan-in scales, or on the card: see ``card``)
and its 4 right-padded prompts, then prefills three times on the CPU,
recording a digest of every layer's router logits and of
the last-token logits for each call. Before the model it multiplies a few
matrices of the prefill's shapes three times each (first call against
later ones). A variant sets the environment of its workers, or what they
do:

    base        as above
    hashfirst   call 1 runs under a dispatch mode that digests the output of
                every aten op, so a spread between processes can be traced
                to the first op that differs
    warm        one prefill of other prompts before the three calls
    mkl_cbwr    MKL_CBWR=COMPATIBLE
    mkl_dynamic MKL_DYNAMIC=FALSE
    one_thread  torch.set_num_threads(1)
    card        phase 6 itself: the weights drawn on the card (a CUDA
                generator seeded 0) and copied to the host model, the card
                prefill first, then the host's; each host call's router and
                last-token logits are also compared with the card's
                (max |host - card| / max |host|, per layer and the last)
    card_mkl_dynamic, card_cbwr   card, with MKL_DYNAMIC=FALSE or
                MKL_CBWR=COMPATIBLE
    card_hashfirst   card, its first host call digested op by op

The parent prints, per variant, how many processes' digests differ from the
most common one at each call, and the first op where they part.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENV = {"mkl_cbwr": {"MKL_CBWR": "COMPATIBLE"},
       "mkl_dynamic": {"MKL_DYNAMIC": "FALSE"},
       "card_cbwr": {"MKL_CBWR": "COMPATIBLE"},
       "card_mkl_dynamic": {"MKL_DYNAMIC": "FALSE"}}
MATMULS = ((2048, 1024, 32), (2048, 1024, 1024), (2048, 1024, 512),
           (4, 1024, 49155))


def _digest(t) -> str:
    """The tensor's size and the xor and wrapped sum of its 32-bit words:
    any flipped bit changes the xor."""
    import numpy as np
    import torch
    t = t.detach().contiguous().cpu().reshape(-1)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    raw = t.view(torch.uint8).numpy().reshape(-1)
    if raw.size % 4:
        raw = np.concatenate([raw, np.zeros(4 - raw.size % 4, np.uint8)])
    words = raw.view(np.uint32)
    if not words.size:
        return "empty"
    return (f"{t.numel()}:{int(np.bitwise_xor.reduce(words)):08x}:"
            f"{int(words.sum(dtype=np.uint64)):x}")


def _op_mode(log):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Digest(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            log.append([str(func)] + [_digest(o) for o in outs
                                      if isinstance(o, torch.Tensor)])
            return out
    return Digest()


def worker(variant: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models import moe as moe_mod

    if variant == "one_thread":
        torch.set_num_threads(1)
    out = {"threads": torch.get_num_threads(), "matmuls": []}
    g = torch.Generator().manual_seed(7)
    for m, k, n in MATMULS:
        a = torch.randn((m, k), generator=g)
        b = torch.randn((k, n), generator=g)
        out["matmuls"].append([_digest(a @ b) for _ in range(3)])

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2,
                              dtype="float32", kv_cache_dtype="float32")
    lm = LM(cfg, device="cpu")
    card = variant.startswith("card")
    if card:                   # as chip_smoke.py's phase 6
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        on_card = LM(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        lm.load_state_dict({n: t.cpu()
                            for n, t in on_card.state_dict().items()})
    else:
        with torch.no_grad():  # LM.init's scales, normal draws (faster)
            for p in lm.parameters():
                p.copy_(torch.randn(p.shape, generator=g)
                        * (p.shape[-2] ** -0.5 if p.dim() > 1 else 1.0))
    rng = np.random.default_rng(2)
    lens = rng.integers(100, 513, size=4).astype(np.int32)
    toks = np.zeros((4, 512), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)

    routers = []
    plain = moe_mod.dispatch_grouped

    def recording(logits, **kw):
        routers.append(logits.cpu())
        return plain(logits, **kw)
    moe_mod.dispatch_grouped = recording
    if card:
        card_logits, _ = on_card.prefill(on_card.init_cache(4, 512), toks,
                                         lens)
        card_routers, card_logits = list(routers), card_logits.cpu()
        out["card_logits"] = _digest(card_logits)
    if variant == "warm":
        other = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                  size=(4, 512))
        lm.prefill(lm.init_cache(4, 512), other, np.full(4, 512, np.int32))
    hashed = 0 if variant.endswith("hashfirst") else None
    out["calls"], out["ops"] = [], []
    for call in range(3):
        routers.clear()
        t0 = time.perf_counter()
        if call == hashed:
            with _op_mode(out["ops"]):
                logits, _ = lm.prefill(lm.init_cache(4, 512), toks, lens)
        else:
            logits, _ = lm.prefill(lm.init_cache(4, 512), toks, lens)
        rec = {"routers": [_digest(r) for r in routers],
               "logits": _digest(logits), "s": time.perf_counter() - t0}
        if card:
            rec["errs"] = [
                ((h - c).abs().max() / h.abs().max()).item()
                for h, c in zip(routers + [logits],
                                card_routers + [card_logits])]
        out["calls"].append(rec)
    return out


def _spread(keys: list) -> int:
    """How many entries differ from the most common one."""
    if not keys:
        return 0
    return len(keys) - collections.Counter(keys).most_common(1)[0][1]


def summarize(variant: str, runs: list[dict]) -> dict:
    calls = {}
    for c in range(3):
        calls[f"call{c + 1}"] = {
            "logits_off": _spread([r["calls"][c]["logits"] for r in runs]),
            "routers_off": _spread([tuple(r["calls"][c]["routers"])
                                    for r in runs]),
            "mean_s": sum(r["calls"][c]["s"] for r in runs) / len(runs)}
        if "errs" in runs[0]["calls"][c]:
            common = collections.Counter(
                r["calls"][c]["logits"] for r in runs).most_common(1)[0][0]
            calls[f"call{c + 1}"]["errs_of_the_parted"] = [
                r["calls"][c]["errs"] for r in runs
                if r["calls"][c]["logits"] != common]
            errs = sorted(max(r["calls"][c]["errs"]) for r in runs)
            calls[f"call{c + 1}"]["err_vs_card_top3"] = errs[-3:]
            calls[f"call{c + 1}"]["err_vs_card_median"] = errs[len(errs)
                                                              // 2]
    within = sum(len({r["calls"][c]["logits"] for c in range(3)}) > 1
                 for r in runs)
    mm = [{"shape": list(MATMULS[i]),
           "first_off": _spread([r["matmuls"][i][0] for r in runs]),
           "later_off": _spread([r["matmuls"][i][j] for r in runs
                                 for j in (1, 2)]),
           "first_vs_later": sum(r["matmuls"][i][0] != r["matmuls"][i][1]
                                 for r in runs)}
          for i in range(len(MATMULS))]
    first_op = None
    n_ops = min(len(r["ops"]) for r in runs) if runs else 0
    for i in range(n_ops):
        rows = [tuple(r["ops"][i]) for r in runs]
        if _spread(rows):
            first_op = {"index": i, "op": rows[0][0],
                        "off": _spread(rows)}
            break
    return {"variant": variant, "procs": len(runs),
            "threads": sorted({r["threads"] for r in runs}),
            "calls": calls, "processes_whose_calls_differ": within,
            "matmuls": mm, "ops_digested": n_ops,
            "first_op_that_parts": first_op}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=40)
    ap.add_argument("--variants", default="base,hashfirst")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    report = []
    if "card" in args.variants:    # build the kernels once, not per worker
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build
        _build.build()
    with open("/proc/cpuinfo") as f:
        cpu = next((ln.split(":", 1)[1].strip() for ln in f
                    if ln.startswith("model name")), "unknown")
    print(json.dumps({"cpu": cpu}), flush=True)
    for variant in args.variants.split(","):
        env = {**os.environ, **ENV.get(variant, {})}
        runs, t0 = [], time.perf_counter()
        for _ in range(args.procs):
            proc = subprocess.run(
                [sys.executable, __file__, "--worker", variant], env=env,
                capture_output=True, text=True, timeout=600, check=True)
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        rec = summarize(variant, runs)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        report.append(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
