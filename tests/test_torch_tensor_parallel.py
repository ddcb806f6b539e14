"""The port's split over the mesh's ``model`` axis, layer by layer and in
FLOPs (no JAX: the layers are held against themselves unsplit, which the
other port tests hold against the JAX package).

* Every layer split over a (1, m) ``("data", "model")`` mesh of m gloo
  ranks (``_torch_tp_fns.split_layers``, m = 2 and 4), against the same
  layer run whole in the same process from the same weights and input
  (numpy, seeded): attention with the KV heads split and, for granite's 2
  KV heads on 4 ranks and for 12 query heads on 6 KV heads, not (each rank
  projecting the KV heads its query heads read, one, or where its heads
  straddle groups, two, each query head then reading its own); the gated
  MLP; MoE with the experts on ``model``
  and the legacy layout's ff split, in the scatter and the einsum mode;
  Mamba with ``in_proj``'s columns aligned to the rank's channels; the
  vocabulary-parallel embedding, tied logits and cross-entropy. The output
  and every gradient (a split leaf's gathered, a whole leaf's parts
  summed) within 1e-5 x its max|value| (``test_torch_sharded_step.py``'s
  gradient bound); the MoE aux loss likewise and its counters equal.
* ``launch.shardings.compute_split`` reads the split from the activation
  rules and ``moe_layout`` as the JAX plans fit them.
* FLOPs: a model-axis rank's step issues the replicated step's matmuls in
  the same order, each with exactly 1/m of its FLOPs where it is split,
  counted op by op on meta tensors over a ``fake`` world of 8 ranks: every
  matmul of olmo-1b and falcon-mamba-7b, all of granite's but the
  router's, and on (2, 4), where its 2 KV heads do not split 4 ways, the
  KV projections at 1/2: a rank projects the one KV head its query head
  reads.
"""

import contextlib
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import _torch_tp_fns as tp
from _torch_ranks import run_ranks
from repro_torch.configs import get_config
from repro_torch.launch.shardings import activation_rules, compute_split
from repro_torch.models import LM
from repro_torch.models.distributed import ModelSplit
from repro_torch.optim import AdamW, constant
from repro_torch.train import make_train_step
from repro_torch.train import sharded

TOL = 1e-5


@pytest.mark.parametrize("m", [2, 4])
def test_every_layer_split_matches_it_whole(tmp_path, m):
    ranks = run_ranks(tp.split_layers, m, tmp_path, 0, timeout=240)
    cases = ranks[0]
    assert len(cases) == 10
    assert f"attention granite-moe-1b-a400m kv_split={m == 2}" in cases
    assert f"attention 12 heads on 6 KV heads kv_split={m == 2}" in cases
    for res in ranks:
        assert res.keys() == cases.keys()
        for case, errs in res.items():
            for name, err in errs.items():
                assert err <= TOL, (case, name, err)


class _Mesh:
    """A stand-in with the JAX mesh's ``axis_names`` and ``devices``."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = torch.empty(shape).numpy()


@pytest.mark.parametrize("arch,shape,want", [
    ("granite-moe-1b-a400m", (16, 16),
     dict(heads=True, kv_heads=False, ff=True, vocab=True, experts=True,
          moe_ff=False, inner=False, ep=False)),
    ("granite-moe-1b-a400m", (16, 1), dict.fromkeys(ModelSplit.KEYS,
                                                     False)),
    ("olmo-1b", (16, 16), dict(heads=True, kv_heads=True, ff=True,
                               vocab=True, experts=False, moe_ff=False,
                               inner=False, ep=False)),
    ("falcon-mamba-7b", (16, 16), dict(heads=False, kv_heads=False,
                                       ff=False, vocab=True, experts=False,
                                       moe_ff=False, inner=True, ep=False)),
    ("jamba-v0.1-52b", (16, 16), dict(heads=True, kv_heads=False, ff=True,
                                      vocab=True, experts=True,
                                      moe_ff=False, inner=True, ep=False)),
])
def test_compute_split_reads_the_activation_rules(arch, shape, want):
    cfg = get_config(arch)
    mesh = _Mesh(shape, ("data", "model"))
    assert compute_split(cfg, mesh) == want
    # the legacy layout splits the experts' ff, not the experts
    if cfg.n_experts and shape[1] > 1:
        legacy = dataclasses.replace(cfg, moe_layout_mode="legacy")
        got = compute_split(legacy, mesh)
        assert (got["experts"], got["moe_ff"]) == (False, True)
        rules = activation_rules(legacy, mesh)
        assert rules["moe_ff"] == "model" and rules["experts"] is None


class _Matmuls(TorchDispatchMode):
    """Each matmul's (op, FLOPs), in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.ops.append((str(packet),
                             flop_registry[packet](*args, **kwargs,
                                                   out_val=out)))
        return out


def _step_matmuls(cfg, shape, split: bool):
    """The matmuls of model-axis rank 0's loss and gradients, on meta
    tensors over a fake world of 8 ranks on the ``shape`` mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        rules = activation_rules(cfg, mesh)
        lm = LM(cfg, device="meta").requires_grad_(True)
        with contextlib.ExitStack() as stack:
            if not split:
                stack.enter_context(_no_split())
            state, sharding = sharded.shard_state(lm, AdamW(), mesh, rules)
        step = make_train_step(lm, AdamW(), constant(1e-3), remat=True,
                               sharding=sharding)
        tokens = torch.zeros((8, 32), dtype=torch.int32, device="meta")
        with _Matmuls() as rec:
            step.loss_grads(state.params, {"tokens": tokens,
                                           "labels": tokens})
        return rec.ops
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _no_split():
    real = sharded.compute_split

    def none(cfg, mesh, rules=None):
        return dict.fromkeys(real(cfg, mesh, rules), False)
    sharded.compute_split = none
    try:
        yield
    finally:
        sharded.compute_split = real


@pytest.mark.parametrize("arch", ["olmo-1b", "falcon-mamba-7b",
                                  "granite-moe-1b-a400m"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_a_model_rank_computes_one_mth_of_each_split_matmul(arch, shape):
    cfg = get_config(arch).smoke()
    m = shape[1]
    whole = _step_matmuls(cfg, shape, split=False)
    split = _step_matmuls(cfg, shape, split=True)
    assert [op for op, _ in split] == [op for op, _ in whole]
    ratios = [s / w for (_, s), (_, w) in zip(split, whole)]
    kv_ratio = 1.0 / cfg.n_kv_heads if cfg.n_kv_heads % m else 1.0 / m
    assert set(ratios) <= {1.0, 1.0 / m, kv_ratio}, set(ratios)
    kept = sum(w for (_, w), r in zip(whole, ratios) if r == 1.0)
    if arch == "granite-moe-1b-a400m":
        # the router (x @ (d, E)) runs whole on every model rank: a
        # product forward, again in the remat recompute, two backward
        per_width = cfg.n_layers * 4 * 2 * (8 // shape[0] * 32) * \
            cfg.d_model
        assert kept == per_width * cfg.n_experts
        if cfg.n_kv_heads % m:
            # where the KV heads do not split, the KV projections of the
            # one KV head a rank's query heads read
            kv = sum(w for (_, w), r in zip(whole, ratios) if r == kv_ratio)
            assert kv == per_width * 2 * cfg.n_kv_heads * cfg.head_dim_
    else:
        assert kept == 0
