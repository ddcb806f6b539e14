"""Rank functions of the sharded serving tests (run by
``_torch_ranks.run_ranks``, one per gloo rank; no JAX): ``LM.prefill``
and ``LM.decode_step`` of a sharded LM, each rank computing its share over
``model`` from its block of the cache, against the unsharded LM in the
same process."""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh


def _leaves(cache) -> list:
    if isinstance(cache, dict):
        return [t for key in sorted(cache) for t in _leaves(cache[key])]
    return list(cache)


def _run(lm, cache, toks, lens, feed):
    """Prefill, then one decode step a row of ``feed`` (S, B) at lengths
    ``lens + step``; the float32 logits of each call, (B, V)."""
    out = []
    logits, cache = lm.prefill(cache, toks, lens)
    out.append(logits)
    for step, nxt in enumerate(feed):
        logits, cache = lm.decode_step(cache, nxt[:, None], lens + step)
        out.append(logits[:, 0])
    return out, cache


def serve_cases(rank, world, cases):
    """Each case ``(cfg, state_dict, toks, lens, max_len, feed, shape,
    axes)``: the LM sharded on a ``shape`` mesh of ``axes`` with the serve
    cell's rules, its cache from ``init_cache`` (the whole batch's rows),
    prefill and ``len(feed)`` decode steps on this rank's rows. Returns per
    case on every rank its cache's local shapes, its sequence block, its
    split flags and whether ``shard_cache`` of the gathered cache gives
    its block back bit for bit; on rank 0 also every call's logits (rows
    gathered over the batch's ranks), the cache gathered whole and the
    unsharded LM's logits and cache on the same inputs."""
    from repro_torch.launch.shardings import (
        activation_rules,
        placements,
        serve_shape,
    )
    from repro_torch.models import LM
    from repro_torch.models.distributed import gather_full
    from repro_torch.train.sharded import (
        gather_cache,
        shard_cache,
        shard_params,
    )

    results = []
    for cfg, state_dict, toks, lens, max_len, feed, shape, axes in cases:
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes)
        b = toks.shape[0]
        rules = activation_rules(cfg, mesh, serve_shape(b, max_len))
        lm = LM(cfg, device="cpu")
        lm.load_state_dict(state_dict)
        shard_params(lm, mesh, rules)
        cache = lm.init_cache(b, max_len)
        res = {"shapes": [tuple(t.shape) for t in _leaves(cache)],
               "seq": (lm.seq.lo, lm.seq.block, lm.seq.size),
               "split": lm.split.flags(), "moves": lm.split.moves,
               "rows": lm.batch.ranks}
        rows = lm.batch.rows
        toks_t, lens_t = torch.from_numpy(toks), torch.from_numpy(lens)
        feed_t = torch.from_numpy(feed)
        got, cache = _run(lm, cache, rows(toks_t), rows(lens_t),
                          [rows(f) for f in feed_t])
        by_rows = placements(mesh, (rules["batch"], None))
        got = [gather_full(g, mesh, by_rows) for g in got]
        whole = gather_cache(lm, cache)
        res["again"] = [torch.equal(a, b) for a, b in zip(
            _leaves(shard_cache(lm, whole)), _leaves(cache))]
        if rank == 0:
            ref = LM(cfg, device="cpu")
            ref.load_state_dict(state_dict)
            want, want_cache = _run(ref, ref.init_cache(b, max_len), toks_t,
                                    lens_t, feed_t)
            res.update(
                logits=[g.numpy() for g in got],
                cache=[t.float().numpy() for t in _leaves(whole)],
                want=[w.numpy() for w in want],
                want_cache=[t.float().numpy() for t in _leaves(want_cache)])
        results.append(res)
    return results


def greedy(logits: list) -> np.ndarray:
    """The argmax token of each call's logits, (calls, B)."""
    return np.stack([np.asarray(g).argmax(-1) for g in logits])
