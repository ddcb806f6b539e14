"""The port's sharded train step against its single-process step on the
CPU: 8 gloo ranks (``_torch_ranks.run_ranks``) on the production mesh
patched to a small one, as ``tests/test_sharding_dryrun.py`` patches the
JAX package's — (4, 2) ``("data", "model")``, and (2, 2, 2) with ``pod``,
where the AdamW moments are widened over ``(pod, data)`` (ZeRO-1) — from
the same converted JAX weights and one batch.

Bounds, each per leaf or per run:
  * the loss (the whole batch's, summed from every rank's share) within
    1e-6 relative; every metric within 1e-6 relative;
  * every gradient, gathered from its shards, within 1e-5 x the leaf's
    max|g|;
  * every parameter after one AdamW step, gathered, within 1e-5 x the
    leaf's max|p|, both optimizers at ``eps=1e-4`` as
    ``tests/test_torch_train.py`` runs them, for the reason its docstring
    gives;
  * and the reference test's own bounds: loss within 1e-3, grad norm
    within 1e-2 relative.
The sharded loss, its metrics and the gathered gradients are also held
against ``jax.value_and_grad`` of the JAX package's ``LM.loss`` on the same
batch and weights, at ``test_torch_grad.py``'s bounds (loss within 1e-5
relative, each gradient within 1e-4 x its leaf's max|g|, for the reasons
its docstring gives), so a fault that both of the port's paths share
would show. Each rank holds less than the whole model.
"""

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import _torch_rank_fns as fns  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, from_jax_params  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.optim.adamw import tree_items  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
PARAM_TOL = 1e-5
STEP_EPS = 1e-4
JAX_LOSS_RTOL = 1e-5     # test_torch_grad.py's bounds
JAX_GRAD_TOL = 1e-4


def _jax(arch):
    """The JAX LM of the smoke config and its weights."""
    jlm = JaxLM(JAX_REGISTRY[arch].smoke())
    return jlm, jlm.init(jax.random.key(0))


def _jax_loss_and_grads(jlm, params, batch):
    """``jax.value_and_grad`` of the JAX LM's loss: (loss, metrics, the
    gradients under the port's parameter names)."""
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, b), has_aux=True))(
            params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    return float(loss), metrics, from_jax_params(
        jlm.cfg, jax.tree.map(np.asarray, grads))


def _batch(cfg):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, 20:] = -1                  # ranks with unequal label counts
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


@pytest.mark.parametrize("arch,multi_pod", [
    ("olmo-1b", False), ("granite-moe-1b-a400m", False), ("olmo-1b", True)])
def test_sharded_step_matches_one_process(tmp_path, arch, multi_pod):
    cfg = get_config(arch).smoke()
    jlm, jparams = _jax(arch)
    state_dict = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    batch = _batch(cfg)
    ranks = run_ranks(fns.sharded_step, 8, tmp_path, arch, state_dict,
                      batch, multi_pod, STEP_EPS, timeout=180)
    got = ranks[0]

    jloss, jmetrics, jgrads = _jax_loss_and_grads(jlm, jparams, batch)
    assert abs(got["metrics"]["loss"] - jloss) <= JAX_LOSS_RTOL * abs(jloss)
    np.testing.assert_allclose(got["metrics"]["ce"], float(jmetrics["ce"]),
                               rtol=JAX_LOSS_RTOL)
    for key in ("tokens", "overflow", "rebalanced", "dropped"):
        assert got["metrics"][key] == int(jmetrics[key]), key
    assert sorted(got["grads"]) == sorted(jgrads)
    for name, want in jgrads.items():
        want = want.numpy()
        err = np.abs(got["grads"][name].numpy() - want).max()
        assert err <= JAX_GRAD_TOL * np.abs(want).max(), name

    lm = LM(cfg, device="cpu")
    lm.load_state_dict(state_dict)
    opt = AdamW(weight_decay=0.1, eps=STEP_EPS)
    state = init_state(lm, opt)
    step = make_train_step(lm, opt, constant(1e-3), remat=True,
                           clip_norm=0.5)
    _, _, grads = step.loss_grads(state.params, batch)
    state, metrics = step(state, batch)

    loss = float(metrics["loss"])
    assert abs(got["metrics"]["loss"] - loss) <= LOSS_RTOL * abs(loss)
    assert abs(got["metrics"]["loss"] - loss) < 1e-3
    gn = float(metrics["grad_norm"])
    assert abs(got["metrics"]["grad_norm"] - gn) / gn < 1e-2
    assert sorted(got["metrics"]) == sorted(metrics)
    for key, value in metrics.items():
        np.testing.assert_allclose(got["metrics"][key], float(value),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert got["step"] == 1
    for path, g in tree_items(grads):
        name = ".".join(path)
        err = (got["grads"][name] - g).abs().max().item()
        assert err <= GRAD_TOL * g.abs().max().item(), name
    for name, p in lm.named_parameters():
        w = p.detach()
        err = (got["params"][name] - w).abs().max().item()
        assert err <= PARAM_TOL * w.abs().max().item(), name
    whole = sum(p.numel() * p.element_size() for p in lm.parameters())
    assert all(r["local_param_bytes"] < whole / 2 for r in ranks)
