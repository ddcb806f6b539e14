"""Serving CLI: continuous batching with the PSTS request scheduler, on the
CUDA device unless ``--device cpu`` is given, for any config of
``configs``: attention with MLP or MoE layers (granite-moe, ...), Mamba
layers (falcon-mamba-7b) or hybrid periods (jamba, at its smoke size on one
card).

  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --smoke \\
      --requests 16 --max-new 8 --replicas 2 --device cpu
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --requests 16 \\
      --prompt-len 2048 --max-new 32 --slots 4 --max-len 4096 --replicas 2

Prints one JSON line (finished requests, generated tokens, wall seconds,
tokens/s, replica loads), as ``repro.launch.serve`` does. The prompts are
the JAX CLI's: per request, a length uniform in [4, --prompt-len] and then
its tokens, both from ``np.random.default_rng(--seed)``. The weights are
drawn by ``LM.init`` from a ``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import LM
from ..sched.request_sched import ReplicaScheduler
from ..serve import Engine, GenRequest

__all__ = ["build_lm", "serve", "main"]


def build_lm(arch: str, *, smoke: bool = False, seed: int = 0,
             device=None) -> LM:
    """The LM of ``arch`` (its smoke config if ``smoke``) on ``device``
    (None: the CUDA device, or raise), weights drawn from ``seed``."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    lm = LM(cfg, device=device)
    return lm.init(torch.Generator(device=lm.device).manual_seed(seed))


def serve(lm: LM, prompts, *, max_new: int, slots: int, max_len: int,
          replicas: int = 1):
    """Place each prompt on a replica by the PSTS request scheduler, then run
    each replica's engine until its requests finish. Returns ``(summary,
    done, sched)``: the CLI's JSON record, the finished ``GenRequest``s and
    the scheduler."""
    engines = [Engine(lm, slots=slots, max_len=max_len)
               for _ in range(replicas)]
    sched = ReplicaScheduler(dims=(replicas,))
    t0 = time.perf_counter()
    per_replica: dict[int, list[GenRequest]] = {i: [] for i in
                                                range(replicas)}
    for prompt in prompts:
        req = sched.submit(len(prompt), max_new)
        per_replica[req.replica].append(GenRequest(req.rid, prompt, max_new))
    done = []
    for rep, reqs in per_replica.items():
        done += engines[rep].run(reqs)
    if lm.device.type == "cuda":
        torch.cuda.synchronize(lm.device)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in done)
    summary = {
        "finished": len(done),
        "generated_tokens": tokens,
        "wall_s": round(dt, 2),
        "tok_per_s": round(tokens / dt, 1),
        "replica_loads": sched.loads().tolist(),
    }
    return summary, done, sched


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA device (cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    lm = build_lm(args.arch, smoke=args.smoke, seed=args.seed,
                  device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = []
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        prompts.append(rng.integers(0, lm.cfg.vocab_size, size=plen)
                       .astype(np.int32))
    summary, done, _ = serve(lm, prompts, max_new=args.max_new,
                             slots=args.slots, max_len=args.max_len,
                             replicas=args.replicas)
    print(json.dumps(summary))
    if len(done) != args.requests:
        raise SystemExit(f"only {len(done)} of {args.requests} requests "
                         f"finished")


if __name__ == "__main__":
    main()
