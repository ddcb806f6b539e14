"""Expert parallelism over the ``expert`` axis: on an ``ep`` mesh each
expert rank holds and runs only its own experts, ``[r E/ep, (r + 1)
E/ep)``, and the tokens go to them and back by all-to-alls
(``models.distributed.ModelSplit.to_experts`` / ``from_experts``).

granite-moe-1b-a400m's smoke config (4 experts, k 2) on 8 gloo ranks
(``_torch_ranks.run_ranks``) on two ``("expert", "data", "model")``
meshes: (2, 2, 2), two experts a rank and their ff columns split over
``model``, and (4, 2, 1), one expert a rank and no model split.

* The all-to-all Function: forward and backward against each rank's
  input gathered, bit for bit, in float32 and bfloat16.
* The split train step, in ``scatter`` mode on both meshes and in
  ``einsum`` mode on (2, 2, 2), against the one-process step and
  ``jax.value_and_grad`` of the JAX package's ``LM.loss`` at
  ``test_torch_sharded_step_tp.py``'s bounds (its docstring).
* What the step does, op by op (``_torch_ep_fns.ExpertWatch``): no
  all-gather over ``expert``, six all-to-alls over it a MoE layer
  (dispatch and return in the forward, the remat recompute and the
  backward), no other collective over it of a 3-D tensor (the experts'
  gradients are not summed over ``expert``), and no rank ever makes a
  tensor of the experts' shape larger than its E/ep experts' weights.
* Serving (``LM.prefill`` and 12 decode steps) against the unsharded port
  and the JAX package at ``test_torch_sharded_serve.py``'s bounds, with a
  row a rank of ``expert`` x ``data`` (4 rows on (2, 2, 2), 8 on (4, 2,
  1): the rows split over ``expert`` and the tokens move) and with 2 rows
  (not split: each rank runs its experts on every row and the partial
  combine is summed over ``expert``); no all-gather of the experts'
  weights over ``expert``.
* The dry run of granite's ``train_4k`` cell cut to 2 of its 24 layers on
  ``make_production_mesh(ep=4)`` (a ``fake`` world of 256 ranks): the
  state bytes a rank are the JAX package's plan's, the FLOPs a rank
  within 1% of the step that ran every expert on every expert rank (the
  same products, moved), twelve all-to-alls over ``expert`` of the slot
  tensor's bytes, and no all-gather over ``expert``.
"""

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import _torch_ep_fns as ep_fns  # noqa: E402
import _torch_serve_fns as serve_fns  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models.common import dtype_of as jax_dtype  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, from_jax_params  # noqa: E402
from repro_torch.models.distributed import ModelSplit  # noqa: E402
from repro_torch.models.moe import moe_capacity  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.optim.adamw import tree_items  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402
from test_torch_sharded_serve import (  # noqa: E402
    JAX_TOL,
    MAX_LEN,
    PORT_TOL,
    _jax_run,
    _port_run,
    _rel,
)
from test_torch_sharded_step import (  # noqa: E402
    GRAD_TOL,
    JAX_GRAD_TOL,
    JAX_LOSS_RTOL,
    LOSS_RTOL,
    PARAM_TOL,
    STEP_EPS,
    _batch,
    _jax_loss_and_grads,
)
from test_torch_sharded_step_tp import (  # noqa: E402
    CLIP,
    LR,
    _first_update,
    _want_split,
)

ARCH = "granite-moe-1b-a400m"
AXES = ("expert", "data", "model")
MESHES = {"2x2x2": (2, 2, 2), "4x2x1": (4, 2, 1)}
STEP_CASES = [("2x2x2", "scatter"), ("4x2x1", "scatter"),
              ("2x2x2", "einsum")]
LENGTHS = (5, 21, 40, 9, 33, 12, 27, 3)
# rows of the prompts: a row a rank of expert x data (split), 2 (not)
SERVE_CASES = [("2x2x2", 4), ("2x2x2", 2), ("4x2x1", 8), ("4x2x1", 2)]
SERVE_ROWS = {8: slice(None), 4: slice(0, 4), 2: slice(1, 3)}
SEED = 11


def _cfg(mode="scatter"):
    return dataclasses.replace(get_config(ARCH).smoke(), moe_mode=mode)


def _one_process(cfg, state_dict, batch):
    """The one-process step: (its gradients, its metrics, the LM after
    it)."""
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(state_dict)
    opt = AdamW(weight_decay=0.1, eps=STEP_EPS)
    state = init_state(lm, opt)
    step = make_train_step(lm, opt, constant(LR), remat=True,
                           clip_norm=CLIP)
    _, _, grads = step.loss_grads(state.params, batch)
    _, metrics = step(state, batch)
    return grads, metrics, lm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns of 8 ranks, in threads, while the JAX package and the
    one-process references run here."""
    cfg = _cfg()
    jcfg = JAX_REGISTRY[ARCH].smoke()
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(0))
    state_dict = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    batch = _batch(cfg)
    rng = np.random.default_rng(0)
    toks = np.zeros((len(LENGTHS), max(LENGTHS)), np.int32)
    for i, n in enumerate(LENGTHS):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
    lens = np.array(LENGTHS, np.int32)
    feed = _port_run(cfg, state_dict, toks, lens)
    # each spawn gets tensors of its own: starting the ranks moves a
    # tensor's storage to shared memory in place, which would pull memory
    # from under the references computed here meanwhile
    serve_state = {k: v.clone() for k, v in state_dict.items()}
    serve_cases = [(cfg, serve_state, toks[SERVE_ROWS[b]],
                    lens[SERVE_ROWS[b]], MAX_LEN, feed[:, SERVE_ROWS[b]],
                    MESHES[mesh], AXES) for mesh, b in SERVE_CASES]
    step_cases = [(MESHES[mesh], AXES, {"moe_mode": mode})
                  for mesh, mode in STEP_CASES]
    tmp = tmp_path_factory.mktemp("ep")
    with ThreadPoolExecutor(2) as pool:
        steps = pool.submit(run_ranks, ep_fns.ep_world, 8, tmp, ARCH,
                            {k: v.clone() for k, v in state_dict.items()},
                            {k: v.clone() for k, v in batch.items()},
                            step_cases, STEP_EPS, SEED, timeout=300)
        serving = pool.submit(run_ranks, ep_fns.ep_serve, 8, tmp,
                              serve_cases, timeout=300)
        refs = {}
        for mode in ("scatter", "einsum"):
            jlm_m = JaxLM(dataclasses.replace(jcfg, moe_mode=mode))
            refs[mode] = (_jax_loss_and_grads(jlm_m, jparams, batch),
                          _one_process(_cfg(mode), state_dict, batch))
        jax_logits = _jax_run(jlm, jparams, toks, lens)
        return {"steps": steps.result(), "serve": serving.result(),
                "refs": refs, "jax": jax_logits, "feed": feed,
                "batch": batch, "state_dict": state_dict}


def test_all_to_all_forward_and_backward_match_a_gathered_reference(runs):
    for rank in runs["steps"]:
        assert rank["all_to_all"] == {"torch.float32": (True, True),
                                      "torch.bfloat16": (True, True)}


def _want(mesh):
    shape = MESHES[mesh]
    if shape[-1] == 1:
        return dict(dict.fromkeys(ModelSplit.KEYS, False), ep=True)
    return _want_split(_cfg(), shape[-1], AXES)


@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=["-".join(c) for c in STEP_CASES])
def test_split_step_matches_one_process_and_jax(runs, case):
    mesh, mode = STEP_CASES[case]
    ranks = [r["steps"][case] for r in runs["steps"]]
    (jloss, jmetrics, jgrads), (grads, metrics, lm) = runs["refs"][mode]
    after, _ = lm.apply(runs["batch"]["tokens"])
    whole = sum(p.numel() * p.element_size() for p in lm.parameters())
    got = ranks[0]
    assert all(r["split"] == _want(mesh) for r in ranks)
    assert all(r["local_param_bytes"] < whole / 2 for r in ranks)

    assert abs(got["metrics"]["loss"] - jloss) <= JAX_LOSS_RTOL * abs(jloss)
    for key in ("tokens", "overflow", "rebalanced", "dropped"):
        assert got["metrics"][key] == int(jmetrics[key]), key
    assert sorted(got["grads"]) == sorted(jgrads)
    for name, want in jgrads.items():
        want = want.numpy()
        err = np.abs(got["grads"][name].numpy() - want).max()
        assert err <= JAX_GRAD_TOL * np.abs(want).max(), name

    assert sorted(got["metrics"]) == sorted(metrics)
    for key, value in metrics.items():
        np.testing.assert_allclose(got["metrics"][key], float(value),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert got["step"] == 1
    for path, g in tree_items(grads):
        name = ".".join(path)
        err = (got["grads"][name] - g).abs().max().item()
        assert err <= GRAD_TOL * g.abs().max().item(), name
    rows = got["logits"].shape[0]
    err = (got["logits"] - after[:rows]).abs().max().item()
    assert err <= GRAD_TOL * after.abs().max().item()
    for name, p in lm.named_parameters():
        w = p.detach()
        if not runs["state_dict"][name].any():
            w = _first_update(got["grads"][name],
                              got["metrics"]["grad_norm"])
        err = (got["params"][name] - w).abs().max().item()
        assert err <= PARAM_TOL * w.abs().max().item(), name


@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=["-".join(c) for c in STEP_CASES])
def test_step_moves_tokens_not_experts(runs, case):
    mesh, _ = STEP_CASES[case]
    cfg = _cfg()
    ep = MESHES[mesh][0]
    rows = 8 // (ep * MESHES[mesh][1])
    cap = moe_capacity(32, cfg.experts_per_token, cfg.n_experts,
                       cfg.capacity_factor)
    slots = (ep, rows, cfg.n_experts // ep, cap, cfg.d_model)
    for r in runs["steps"]:
        watch = r["steps"][case]["watch"]
        over = [(kind, shape) for kind, axis, shape in watch["collectives"]
                if axis == "expert"]
        moved = [shape for kind, shape in over if kind == "all-to-all"]
        assert moved == [slots] * 6 * cfg.n_layers
        assert not [c for c in over if c[0] == "all-gather"]
        assert not [c for c in over if c[0] != "all-to-all"
                    and len(c[1]) > 2]
        # the rank's experts' weights, gathered over data: their ff
        # columns of the model rank
        assert watch["largest"] == (cfg.n_experts // ep * cfg.d_model
                                    * cfg.d_ff // MESHES[mesh][2])


@pytest.mark.parametrize("mesh,b", SERVE_CASES)
def test_split_serving_matches_the_port_and_jax(runs, mesh, b):
    cfg = _cfg()
    ranks = [r[SERVE_CASES.index((mesh, b))] for r in runs["serve"]]
    jax_logits = [x[SERVE_ROWS[b]] for x in runs["jax"]]
    feed = runs["feed"][:, SERVE_ROWS[b]]
    r0 = ranks[0]
    moves = b == MESHES[mesh][0] * MESHES[mesh][1]
    assert r0["split"] == _want(mesh) and r0["moves"] == moves
    for got, want, jwant in zip(r0["logits"], r0["want"], jax_logits):
        assert _rel(got, want) <= PORT_TOL
        assert _rel(got, jwant) <= JAX_TOL
    assert (serve_fns.greedy(r0["logits"])[:-1] == feed).all()
    assert (serve_fns.greedy(jax_logits) == serve_fns.greedy(
        r0["logits"])).all()
    for got, want in zip(r0["cache"], r0["want_cache"]):
        assert got.shape == want.shape and _rel(got, want) <= PORT_TOL
    calls = 1 + len(feed)
    for r in ranks:
        over = [(kind, shape) for kind, axis, shape in r["collectives"]
                if axis == "expert"]
        assert not [s for k, s in over if k == "all-gather" and len(s) == 3
                    and cfg.d_model in s[1:]]
        moved = [s for k, s in over if k == "all-to-all"]
        assert len(moved) == (2 * calls * cfg.n_layers if moves else 0)


# the FLOPs a rank of the step that gathered every expert over ``expert``
# and ran all 32 on every expert rank (the same cell, host count)
GATHERED_FLOPS = 3133178642432.0
EP = 4


def _jax_plan_bytes(jcfg) -> int:
    """The state bytes a rank holds under the JAX package's plan of
    ``jcfg``'s train state on the (4, 4, 16) ep mesh."""
    from jax.sharding import PartitionSpec as P

    sizes = {"expert": EP, "data": 256 // (EP * 16), "model": 16}
    mesh = SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values()), object))
    opt = JaxAdamW(moments_dtype=jax_dtype(jcfg.moments_dtype))
    st = jax.eval_shape(lambda: jax_init_state(JaxLM(jcfg), opt,
                                               jax.random.key(0)))
    specs = jsh.state_pspecs(st, jcfg, mesh)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(st), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P))):
        shape = list(leaf.shape)
        for i, part in enumerate(spec):
            axes = (part,) if isinstance(part, str) else tuple(part or ())
            shape[i] //= math.prod(sizes[a] for a in axes)
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total


def test_dryrun_ep_cell_moves_the_slots_not_the_experts():
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    rec = dryrun.lower_cell(ARCH, "train_4k", False, cfg=cfg, ep=EP)
    assert rec["mesh"] == "16x16+ep4" and rec["n_devices"] == 256
    jcfg = dataclasses.replace(JAX_REGISTRY[ARCH], n_layers=2)
    assert rec["memory"]["state_bytes"] == _jax_plan_bytes(jcfg)
    assert abs(rec["cost"]["flops"] - GATHERED_FLOPS) <= 1e-2 * \
        GATHERED_FLOPS
    log = rec["collective_log"]
    assert not [c for c in log if c["kind"] == "all-gather"
                and c["axis"] == "expert"]
    moved = [c for c in log if c["kind"] == "all-to-all"]
    rows = 256 // (EP * 4)
    cap = moe_capacity(4096, cfg.experts_per_token, cfg.n_experts,
                       cfg.capacity_factor)
    slot_bytes = rows * cfg.n_experts * cap * cfg.d_model * 2    # bf16
    assert len(moved) == 6 * cfg.n_layers
    assert all(c["axis"] == "expert" and c["group"] == EP
               and c["bytes"] == slot_bytes for c in moved)
    assert rec["collectives"]["by_kind"]["all-to-all"]["bytes"] == \
        len(moved) * slot_bytes * (EP - 1) // EP
