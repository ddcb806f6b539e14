"""The sharded train step with the compute split over ``model``, for
olmo-1b and granite-moe-1b-a400m smoke configs (falcon-mamba-7b and
jamba-v0.1-52b in ``test_torch_sharded_step_tp_ssm.py``) on three meshes
of 8 gloo ranks each (``_torch_ranks.run_ranks``, one spawn a config):
(4, 2) ``("data", "model")``, (2, 2, 2) ``("pod", "data", "model")`` and
(2, 4) ``("data", "model")``, where granite's and jamba's 2 KV heads do
not split 4 ways. Each is held against the one-process step and against
``jax.value_and_grad`` of the JAX package's ``LM.loss`` at
``test_torch_sharded_step.py``'s bounds (its docstring): the loss and
every metric within 1e-6 relative of the one-process step's, every
gradient (gathered) within 1e-5 x the leaf's max|g|, every parameter after
one AdamW step (``eps=1e-4``) within 1e-5 x max|p|; the loss within 1e-5
relative and every gradient within 1e-4 x max|g| of JAX's, the MoE
counters equal; ``LM.apply`` after the step (the logits' vocabulary
columns gathered over ``model``) within 1e-5 x max|logit| of the
one-process LM's. A leaf that is zero at init (Mamba's ``conv_b``) is
after one step AdamW's first update alone, lr g / (|g| + eps), whose slope
in g reaches lr / eps at g = 0, so a gradient within the bound can move it
by far more than 1e-5 x max|p|: there the split step's parameter is held
within 1e-5 x max|p| of AdamW applied to the split step's own gathered
gradient (clipped by its own norm), which the gradient bound holds.
granite also runs on a fourth mesh, (2, 2, 2) ``("expert", "data",
"model")``, an ``ep`` mesh: each expert rank holds and runs its own
experts (``ep``), the tokens moved to them and back by all-to-alls, and
each model rank computes its block of those experts' ff columns
(``moe_ff``), which the plans cut over ``data`` and ``model`` together, so
a rank's columns interleave. Each rank
computes the split the plans give (heads, KV heads where they divide, ff,
vocabulary, experts, Mamba channels) and holds less than half the model.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import _torch_tp_fns as tp  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, from_jax_params  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    clip_by_global_norm,
    tree_items,
)
from repro_torch.train import init_state, make_train_step  # noqa: E402
from test_torch_sharded_step import (  # noqa: E402
    GRAD_TOL,
    JAX_GRAD_TOL,
    JAX_LOSS_RTOL,
    LOSS_RTOL,
    PARAM_TOL,
    STEP_EPS,
    _batch,
    _jax,
    _jax_loss_and_grads,
)

LR, CLIP = 1e-3, 0.5      # _torch_rank_fns.step_on_mesh's
MESHES = [((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((2, 4), ("data", "model"))]
EP_MESH = ((2, 2, 2), ("expert", "data", "model"))


def _want_split(cfg, m, axes=("data", "model")):
    """What the plans split on a model axis of m (every smoke config's
    dims divide it but the KV heads on 4); on a mesh with an ``expert``
    axis (of 2) the experts lie on it, each expert rank runs its own and
    each model rank takes their ff columns."""
    attn, moe, ep = cfg.n_heads > 0, cfg.n_experts > 0, "expert" in axes
    return {"heads": attn, "kv_heads": attn and cfg.n_kv_heads % m == 0,
            "ff": cfg.family != "ssm", "vocab": True,
            "experts": moe and not ep, "moe_ff": moe and ep,
            "inner": cfg.is_ssm, "ep": moe and ep}


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_split_step_matches_one_process_and_jax(tmp_path, arch):
    meshes = MESHES + [EP_MESH] if arch == "granite-moe-1b-a400m" \
        else MESHES
    check_split_step(tmp_path, arch, meshes)


def check_split_step(tmp_path, arch, meshes=MESHES):
    """The split step of ``arch``'s smoke config on ``meshes`` against the
    one-process step and JAX (module docstring)."""
    cfg = get_config(arch).smoke()
    jlm, jparams = _jax(arch)
    state_dict = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    batch = _batch(cfg)
    ranks = run_ranks(tp.split_step_meshes, 8, tmp_path, arch, state_dict,
                      batch, meshes, STEP_EPS, timeout=300)

    jloss, jmetrics, jgrads = _jax_loss_and_grads(jlm, jparams, batch)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(state_dict)
    opt = AdamW(weight_decay=0.1, eps=STEP_EPS)
    state = init_state(lm, opt)
    step = make_train_step(lm, opt, constant(LR), remat=True,
                           clip_norm=CLIP)
    _, _, grads = step.loss_grads(state.params, batch)
    state, metrics = step(state, batch)
    after, _ = lm.apply(batch["tokens"])
    whole = sum(p.numel() * p.element_size() for p in lm.parameters())

    for i, (shape, axes) in enumerate(meshes):
        got = ranks[0][i]
        want_split = _want_split(cfg, shape[-1], axes)
        assert all(r[i]["split"] == want_split for r in ranks), shape
        assert all(r[i]["local_param_bytes"] < whole / 2 for r in ranks)

        assert abs(got["metrics"]["loss"] - jloss) <= JAX_LOSS_RTOL * abs(
            jloss), shape
        for key in ("tokens", "overflow", "rebalanced", "dropped"):
            assert got["metrics"][key] == int(jmetrics[key]), (shape, key)
        assert sorted(got["grads"]) == sorted(jgrads)
        for name, want in jgrads.items():
            want = want.numpy()
            err = np.abs(got["grads"][name].numpy() - want).max()
            assert err <= JAX_GRAD_TOL * np.abs(want).max(), (shape, name)

        assert sorted(got["metrics"]) == sorted(metrics)
        for key, value in metrics.items():
            np.testing.assert_allclose(got["metrics"][key], float(value),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"{shape} {key}")
        assert got["step"] == 1
        for path, g in tree_items(grads):
            name = ".".join(path)
            err = (got["grads"][name] - g).abs().max().item()
            assert err <= GRAD_TOL * g.abs().max().item(), (shape, name)
        # ``apply`` after the step on the first rows, the vocabulary's
        # columns gathered from the model ranks
        rows = got["logits"].shape[0]
        err = (got["logits"] - after[:rows]).abs().max().item()
        assert err <= GRAD_TOL * after.abs().max().item(), shape
        for name, p in lm.named_parameters():
            w = p.detach()
            if not state_dict[name].any():
                # zero at init: AdamW's first update of the split step's
                # own gathered gradient (module docstring)
                w = _first_update(got["grads"][name],
                                  got["metrics"]["grad_norm"])
            err = (got["params"][name] - w).abs().max().item()
            assert err <= PARAM_TOL * w.abs().max().item(), (shape, name)


def _first_update(g, norm):
    """A leaf that is zero before the step after one step of the test's
    AdamW on the gradient ``g``, clipped as the step clips by the global
    norm ``norm``."""
    grads, _ = clip_by_global_norm({"w": g}, CLIP, norm=torch.tensor(
        norm, dtype=torch.float32))
    opt = AdamW(weight_decay=0.1, eps=STEP_EPS)
    params = {"w": torch.zeros_like(g)}
    opt.update(grads, opt.init(params), params, LR)
    return params["w"]
