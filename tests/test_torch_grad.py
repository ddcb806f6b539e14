"""Gradients of the port against the JAX package's on the CPU.

* ``LM.loss`` and every parameter's gradient against
  ``jax.value_and_grad`` of the JAX ``LM.loss``, for every arch of the
  registry at its smoke config, from the same converted parameters and the
  same batch (labels partly masked; the vlm and audio archs with a modality
  prefix). Loss within 1e-5 relative, each gradient within 1e-4 x its
  leaf's max|g|: both sides run in float32, the port's attention is a full
  softmax where the JAX model's is an online one over 512-key blocks, and
  the products sum in other orders. Remat (both policies) equals no remat
  exactly here: the recompute runs the same CPU ops on the same inputs.
* The plain backward versions the card's kernels are held against:
  ``flash_attention_bwd_ref`` against ``jax.grad`` of
  ``repro.kernels.ref.flash_attention_ref`` (window, soft-cap) at 1e-5 x
  max|g|, and ``mamba_scan_bwd_ref`` against autograd of
  ``mamba_scan_ref`` at rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.models import LM as JaxLM
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import ops, ref
from repro_torch.models import LM, from_jax_params

ARCHS = ("granite-moe-1b-a400m", "olmo-1b", "falcon-mamba-7b",
         "jamba-v0.1-52b", "gemma3-4b", "nemotron-4-15b", "qwen1.5-32b",
         "grok-1-314b", "musicgen-large", "internvl2-1b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _batch(cfg, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32)}
    batch["labels"][0, :5] = -1
    if cfg.prefix_len:
        batch["prefix_embed"] = rng.normal(
            size=(b, cfg.prefix_len, cfg.prefix_dim)).astype(np.float32)
    return batch


def _port_lm(arch, params, jcfg, **changes):
    cfg = dataclasses.replace(port_config(arch).smoke(), **changes)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(from_jax_params(jcfg, params))
    return lm.requires_grad_(True)


def _loss_and_grads(lm, batch, remat=False):
    loss, metrics = lm.loss(batch, remat=remat)
    names, tensors = zip(*lm.named_parameters())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return loss, metrics, {n: (torch.zeros_like(t) if g is None else g)
                           for n, t, g in zip(names, tensors, grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg = get_config(arch).smoke()
    jlm = JaxLM(jcfg)
    params = jlm.init(jax.random.key(0))
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    np_params = jax.tree.map(np.asarray, params)
    lm = _port_lm(arch, np_params, jcfg)
    loss, metrics, grads = _loss_and_grads(lm, batch)
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert sorted(metrics) == sorted(jmet)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmet["ce"]),
                               rtol=LOSS_RTOL)
    for key in ("tokens", "overflow", "rebalanced", "dropped"):
        assert int(metrics[key]) == int(jmet[key]), key
    want = from_jax_params(jcfg, jax.tree.map(np.asarray, jgrads))
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        w = want[name].numpy()
        tol = GRAD_TOL * np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= tol, name

    # remat recomputes the same ops on the same inputs: equal exactly
    for policy in ("nothing", "outputs"):
        lm_r = _port_lm(arch, np_params, jcfg, remat_policy=policy)
        loss_r, _, grads_r = _loss_and_grads(lm_r, batch, remat=True)
        assert torch.equal(loss_r, loss), policy
        for name, g in grads.items():
            assert torch.equal(grads_r[name], g), (policy, name)


def test_loss_is_differentiable_only_through_loss():
    """``apply`` stays without autograd; ``loss`` builds a graph on the live
    parameters, and the inference copy follows an in-place update."""
    cfg = get_config("olmo-1b").smoke()
    lm = LM(port_config("olmo-1b").smoke(), device="cpu")
    lm.init(torch.Generator().manual_seed(0)).requires_grad_(True)
    batch = _batch(cfg)
    logits, _ = lm.apply(batch["tokens"])
    assert not logits.requires_grad
    loss, _ = lm.loss(batch)
    assert loss.requires_grad
    with torch.no_grad():
        lm.stages[0].attn.wq.w.mul_(2.0)
    again, _ = lm.apply(batch["tokens"])
    assert not torch.equal(again, logits)


@pytest.mark.parametrize("window,softcap,rep", [(None, None, 2),
                                                (16, None, 1),
                                                (None, 30.0, 4),
                                                (7, 5.0, 2)])
def test_flash_backward_plain_matches_jax_grad(window, softcap, rep):
    rng = np.random.default_rng(7)
    b, kv, s, hd = 2, 2, 40, 16
    h = kv * rep
    q, dout = (rng.normal(size=(b, h, s, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(size=(b, kv, s, hd)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap)

    def f(q, k, v):
        return jnp.vdot(jref.flash_attention_ref(q, k, v, **kw), dout)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    got = ref.flash_attention_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v, dout)), **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # ops.flash_attention on a CPU tensor differentiates the plain version
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, **kw)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for a, g in zip(auto, got):
        assert torch.equal(a, g)


def test_flash_length_form_refuses_a_gradient():
    q = torch.randn(1, 2, 8, 8, requires_grad=True)
    k = torch.randn(1, 1, 8, 8)
    with pytest.raises(ValueError, match="length form"):
        ops.flash_attention(q, k, k, lengths=torch.tensor([5]))
    with torch.no_grad():
        ops.flash_attention(q, k, k, lengths=torch.tensor([5]))


@pytest.mark.parametrize("shape", [(2, 33, 3, 8), (1, 1, 2, 5),
                                   (3, 70, 4, 16)])
def test_mamba_backward_plain_matches_autograd(shape):
    rng = np.random.default_rng(shape[1])
    da = torch.from_numpy(rng.uniform(0.5, 1.0, shape).astype(np.float32))
    dbx = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    leaves = [da.clone().requires_grad_(True), dbx.clone().requires_grad_(
        True)]
    h = ref.mamba_scan_ref(*leaves)
    want = torch.autograd.grad(h, leaves, g)
    got = ref.mamba_scan_bwd_ref(da, h.detach(), g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))
    # and through ops.mamba_scan on the CPU
    auto = torch.autograd.grad(ops.mamba_scan(*leaves), leaves, g)
    for a, w in zip(auto, want):
        assert torch.equal(a, w)
