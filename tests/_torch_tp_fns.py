"""Rank functions of the tensor-parallel tests (run by
``_torch_ranks.run_ranks``, one per gloo rank; no JAX): each layer of the
port run split over a (1, m) ``("data", "model")`` mesh against the same
layer unsplit in the same process, from weights and inputs drawn with
numpy."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# where each leaf of a layer is cut over model (its dim), where the split
# uses it whole and sums its gradient's parts ("parts"), or whole ("whole")
ATTN_CUT = {"wq.w": 1, "wq.b": 0, "wo.w": 0}
MLP_CUT = {"wi.w": 1, "wg.w": 1, "wo.w": 0}
EXPERT_CUT = {"wi": 0, "wg": 0, "wo": 0}
LEGACY_CUT = {"wi": 2, "wg": 2, "wo": 1}
MAMBA_CUT = {"conv_w": 1, "conv_b": 0, "x_proj.w": 0, "dt_proj.w": 1,
             "dt_bias": 0, "A_log": 0, "D": 0, "out_proj.w": 0,
             "in_proj.w": "parts"}


def _nest(flat):
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _draw(module, seed):
    """The module's parameters drawn normal (numpy, ``seed``) at each
    leaf's init scale, as a flat dict of float32 leaves."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module.named_parameters():
        scale = p.shape[0] ** -0.5 if p.dim() > 1 else 0.5
        if name.endswith("A_log"):
            value = np.log(np.arange(1, p.shape[1] + 1, dtype=np.float32)
                           ) * np.ones(p.shape, np.float32)
        else:
            value = rng.standard_normal(p.shape).astype(np.float32) * scale
        out[name] = torch.from_numpy(value)
    return out


def _gather(t, dim, group, m):
    parts = [torch.empty_like(t) for _ in range(m)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _compare(split, whole, cuts, fn, x):
    """Run ``fn(params, x)`` on the whole weights and on this rank's cut
    of them (``cuts``: leaf -> dim, "parts"; the rest whole); the largest
    error over max|value| of the output(s) and of each gradient, the
    split's gradients made whole (cut leaves gathered, parts summed)."""
    m, rank, group = split.size, split.rank, split.group
    full = {k: v.clone().requires_grad_(True) for k, v in whole.items()}
    local = {}
    for k, v in whole.items():
        cut = cuts.get(k)
        if isinstance(cut, int):
            v = v.chunk(m, dim=cut)[rank]
        local[k] = v.clone().requires_grad_(True)
    xf = x.clone().requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    want = fn(None, _nest(full), xf)
    got = fn(split, _nest(local), xs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    g_out = [torch.from_numpy(np.random.default_rng(9).standard_normal(
        w.shape).astype(np.float32)) if w.is_floating_point() else None
        for w in want]
    pairs = [(w, g) for w, g in zip(want, g_out) if g is not None]
    torch.autograd.backward([w for w, _ in pairs], [g for _, g in pairs])
    torch.autograd.backward([s for s, w in zip(got, want)
                             if w.is_floating_point()],
                            [g for g in g_out if g is not None])
    errs = {}
    for i, (s, w) in enumerate(zip(got, want)):
        if w.is_floating_point():
            errs[f"out{i}"] = _rel(s.detach(), w.detach())
        else:
            errs[f"out{i}"] = 0.0 if torch.equal(s, w) else float("inf")
    errs["grad x"] = _rel(xs.grad, xf.grad)
    for k in whole:
        g = local[k].grad
        if g is None:
            g = torch.zeros_like(local[k])
        cut = cuts.get(k)
        if isinstance(cut, int):
            g = _gather(g, cut, group, m)
        elif cut == "parts":
            g = g.clone()
            dist.all_reduce(g, group=group)
        want_g = full[k].grad
        if want_g is None:
            want_g = torch.zeros_like(full[k])
        errs[f"grad {k}"] = _rel(g, want_g)
    return errs


def _rel(got, want) -> float:
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err / scale if scale else err


def _smoke(arch, **changes):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).smoke(), **changes)


def split_layers(rank, world, seed):
    """Every layer's split against its whole run on a (1, world) mesh:
    attention (KV heads split, and not: granite's 2 KV heads on 4 ranks,
    and 12 query heads on 6 KV heads, whose groups a rank's 3 heads
    straddle),
    the gated MLP, MoE with experts on ``model`` and the legacy ff split
    (scatter and einsum), Mamba, and the vocabulary-parallel embedding,
    tied logits and cross-entropy. Returns {case: {value: error}}."""
    from repro_torch.launch.shardings import compute_split
    from repro_torch.models import model as lm_mod
    from repro_torch.models.attention import Attention, attn_train
    from repro_torch.models.common import embed_rows
    from repro_torch.models.distributed import ModelSplit
    from repro_torch.models.mlp import MLP, mlp_apply
    from repro_torch.models.moe import MoE, moe_apply
    from repro_torch.models.ssm import Mamba, ssm_train

    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(seed)
    b, s = 2, 16
    out = {}

    def x_of(d):
        return torch.from_numpy(rng.standard_normal((b, s, d)).astype(
            np.float32))

    def split_of(cfg):
        return ModelSplit(mesh, compute_split(cfg, mesh))

    for name, arch, heads in (
            ("olmo-1b", "olmo-1b", {}),
            ("granite-moe-1b-a400m", "granite-moe-1b-a400m", {}),
            # on 4 ranks a rank's 3 query heads straddle two KV heads
            ("12 heads on 6 KV heads", "granite-moe-1b-a400m",
             dict(n_heads=12, n_kv_heads=6, head_dim=16))):
        cfg = _smoke(arch, qkv_bias=True, **heads)
        split = split_of(cfg)
        assert split.heads
        cuts = dict(ATTN_CUT)
        if split.kv_heads:
            cuts.update({"wk.w": 1, "wk.b": 0, "wv.w": 1, "wv.b": 0})
        else:
            cuts.update({"wk.w": "parts", "wk.b": "parts",
                         "wv.w": "parts", "wv.b": "parts"})
        out[f"attention {name} kv_split={split.kv_heads}"] = _compare(
            split, _draw(Attention(cfg), seed), cuts,
            lambda sp, p, x, cfg=cfg: attn_train(p, x, cfg, split=sp),
            x_of(cfg.d_model))

    cfg = _smoke("olmo-1b")
    split = split_of(cfg)
    assert split.ff
    out["mlp"] = _compare(
        split, _draw(MLP(cfg.d_model, cfg.d_ff, gated=True, n_layers=2),
                     seed), MLP_CUT,
        lambda sp, p, x: mlp_apply(p, x, activation="silu", split=sp),
        x_of(cfg.d_model))

    for layout, cuts in (("auto", EXPERT_CUT), ("legacy", LEGACY_CUT)):
        for mode in ("scatter", "einsum"):
            cfg = _smoke("granite-moe-1b-a400m", moe_layout_mode=layout)
            split = split_of(cfg)
            assert split.experts == (layout == "auto")
            assert split.moe_ff == (layout == "legacy")
            weights = _draw(MoE(cfg), seed)

            def fn(sp, p, x, cfg=cfg, mode=mode):
                y, aux = moe_apply(p, x, cfg, mode=mode, split=sp)
                return (y, aux["moe_aux_loss"], aux["overflow"],
                        aux["rebalanced"], aux["dropped"])
            out[f"moe {layout} {mode}"] = _compare(split, weights, cuts, fn,
                                                   x_of(cfg.d_model))

    cfg = _smoke("falcon-mamba-7b")
    split = split_of(cfg)
    assert split.inner
    out["mamba"] = _compare(
        split, _draw(Mamba(cfg), seed), MAMBA_CUT,
        lambda sp, p, x, cfg=cfg: ssm_train(p, x, cfg, split=sp),
        x_of(cfg.d_model))

    cfg = _smoke("olmo-1b")
    split = split_of(cfg)
    assert split.vocab
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    labels[0, 3:6] = -1
    mask = labels >= 0
    safe = torch.where(mask, labels, 0)
    scale = float(rng.standard_normal() + 3.0)

    def vocab(sp, p, x):
        """embed rows -> a mixing step -> tied logits -> cross-entropy."""
        h = embed_rows(p["w"], tokens, sp) * scale + x
        if sp is not None:
            h2 = sp.copy_to(h)
        else:
            h2 = h
        logits = h2 @ p["w"].T
        if sp is None:
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.take_along_dim(logits, safe[..., None], -1)[..., 0]
        else:
            logz, ll = lm_mod._split_logz_ll(logits, safe, sp)
        return ((logz - ll) * mask).sum() / mask.sum()
    emb = torch.from_numpy(rng.standard_normal(
        (cfg.vocab_padded, cfg.d_model)).astype(np.float32) * 0.1)
    out["vocab loss"] = _compare(split, {"w": emb}, {"w": 0}, vocab,
                                 x_of(cfg.d_model))
    return out


def split_step_meshes(rank, world, arch, state_dict, batch, meshes, eps):
    """``_torch_rank_fns.sharded_step``'s step of the smoke config on each
    mesh of ``meshes`` ((shape, axes) pairs) in turn: on rank 0 the
    gathered gradients, metrics and parameters after one AdamW step, and
    on every rank the compute split and the bytes of its parameter
    shards."""
    import _torch_rank_fns as fns
    out = []
    for shape, axes in meshes:
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes)
        out.append(fns.step_on_mesh(rank, arch, state_dict, batch, mesh,
                                    eps))
    return out


def split_checkpoint(rank, world, arch, state_dict, batch, shape, axes,
                     ckpt_dir):
    """One split AdamW step of the smoke config on the ``shape`` mesh, then
    a sharded checkpoint; a fresh state restored from it. Rank 0 returns
    the step's state gathered whole (params and moments, under the
    checkpoint's names), and every rank whether each restored shard
    equals the saved one bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shardings import activation_rules
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, constant
    from repro_torch.optim.adamw import tree_items
    from repro_torch.train import make_train_step
    from repro_torch.train import sharded

    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes)
    cfg = get_config(arch).smoke()

    def fresh():
        lm = LM(cfg, device="cpu")
        lm.load_state_dict(state_dict)
        lm.requires_grad_(True)
        opt = AdamW(weight_decay=0.1)
        state, sharding = sharded.shard_state(lm, opt, mesh, rules)
        return lm, opt, state, sharding

    rules = activation_rules(cfg, mesh)
    lm, opt, state, sharding = fresh()
    flags = sharding.split.flags()
    step = make_train_step(lm, opt, constant(1e-3), remat=True,
                           sharding=sharding)
    state, _ = step(state, batch)
    sharded.save(ckpt_dir, 1, state)
    dist.barrier()
    whole = {}
    for i, tree in enumerate((state.params, state.opt.m, state.opt.v)):
        for path, t in tree_items(tree):
            whole[(i,) + path] = sharded.gather_leaf(t)
    saved = {(i,) + path: t.to_local().clone()
             for i, tree in enumerate((state.params, state.opt.m,
                                       state.opt.v))
             for path, t in tree_items(tree)}
    _, _, state2, _ = fresh()
    step_no, state2, _ = sharded.restore(ckpt_dir, state2)
    got = {(i,) + path: t.to_local()
           for i, tree in enumerate((state2.params, state2.opt.m,
                                     state2.opt.v))
           for path, t in tree_items(tree)}
    equal = all(torch.equal(saved[k], got[k]) for k in saved)
    res = {"equal": equal, "step": int(step_no), "flags": flags}
    if rank == 0:
        res["whole"] = {k: v.detach().numpy() for k, v in whole.items()}
    return res
