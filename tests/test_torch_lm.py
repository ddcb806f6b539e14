"""The port's LM against the JAX package's on the CPU: ``prefill``,
``decode_step`` and ``apply`` logits and caches, for granite-moe (MoE,
RMSNorm), olmo-1b (dense, non-parametric LayerNorm), falcon-mamba-7b (ssm:
Mamba layers, SSM state and conv caches) and jamba-v0.1-52b (hybrid: Mamba,
attention and MoE sub-layers, a per-sub-layer cache) at their smoke
configs, with the JAX parameters converted by ``from_jax_params`` and
right-padded prompts of several lengths.

Tolerance: 1e-4 x max|logit| on logits, 1e-5 on caches. Both sides run in
float32; the port's attention is a full softmax where the JAX model's is an
online softmax over 512-key blocks, and the matmuls sum in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, get_config
from repro.models import LM as JaxLM
from repro_torch.configs import get_config as port_config
from repro_torch.models import (
    LM,
    attention,
    common,
    from_jax_params,
    mlp,
    moe,
)

ARCHS = ("granite-moe-1b-a400m", "olmo-1b", "falcon-mamba-7b",
         "jamba-v0.1-52b")
LENGTHS = (3, 17, 32, 9)        # one prefill batch, bucket S = 32
MAX_LEN = 48
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = get_config(request.param).smoke()
    jlm = JaxLM(cfg)
    params = jlm.init(jax.random.key(0))
    lm = LM(port_config(request.param).smoke(), device="cpu")
    lm.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                         params)))
    return cfg, jlm, params, lm


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(LENGTHS), max(LENGTHS)), np.int32)
    for i, n in enumerate(LENGTHS):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
    return toks, np.array(LENGTHS, np.int32)


def _close_logits(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= LOGIT_TOL * scale


def _cache_leaves(cache):
    """A cache's tensors in the JAX pytree's leaf order: a dict (the hybrid
    family's ``sub_<j>`` caches) by sorted key, a KVCache/SSMCache by
    field."""
    if isinstance(cache, dict):
        return [t for key in sorted(cache) for t in _cache_leaves(cache[key])]
    return list(cache)


def _close_cache(got, want):
    want = jax.tree.leaves(want)
    got = _cache_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=CACHE_TOL,
                                   atol=CACHE_TOL)


def test_state_dict_covers_every_parameter(pair):
    cfg, jlm, params, lm = pair
    state = from_jax_params(cfg, jax.tree.map(np.asarray, params))
    assert set(state) == set(lm.state_dict())
    n_jax = sum(x.size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in lm.parameters()) == n_jax


def test_prefill_then_decode_match_jax(pair):
    cfg, jlm, params, lm = pair
    toks, lens = _prompts(cfg)
    want_logits, want_cache = jlm.prefill(
        params, jlm.init_cache(len(lens), MAX_LEN), jnp.asarray(toks),
        jnp.asarray(lens))
    cache = lm.init_cache(len(lens), MAX_LEN)
    logits, cache = lm.prefill(cache, toks, lens)
    assert logits.shape == (len(lens), cfg.vocab_padded)
    _close_logits(logits, want_logits)
    _close_cache(cache, want_cache)

    # one decode step from each side's own cache
    nxt = np.asarray(jnp.argmax(want_logits, -1)).astype(np.int32)
    want_logits, want_cache = jlm.decode_step(
        params, want_cache, jnp.asarray(nxt[:, None]), jnp.asarray(lens))
    logits, cache = lm.decode_step(cache, nxt[:, None], lens)
    assert logits.shape == (len(lens), 1, cfg.vocab_padded)
    _close_logits(logits, want_logits)
    _close_cache(cache, want_cache)


@pytest.mark.parametrize("bad", [0, max(LENGTHS) + 1])
def test_prefill_refuses_lengths_outside_1_to_s(pair, bad):
    """Every prompt holds at least one token and fits the batch's width:
    host lengths outside [1, S] are refused before any layer runs (the
    flash kernels' length form takes them unchecked on the card)."""
    cfg, jlm, params, lm = pair
    toks, lens = _prompts(cfg)
    lens[1] = bad
    with pytest.raises(ValueError, match=r"\[1, S = 32\]"):
        lm.prefill(lm.init_cache(len(lens), MAX_LEN), toks, lens)


def test_apply_matches_jax(pair):
    cfg, jlm, params, lm = pair
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    want, want_aux = jlm.apply(params, jnp.asarray(toks))
    got, aux = lm.apply(toks)
    _close_logits(got, want)
    for key in ("overflow", "rebalanced", "dropped"):
        assert int(aux[key]) == int(want_aux[key])
    np.testing.assert_allclose(float(aux["moe_aux_loss"]),
                               float(want_aux["moe_aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_every_family_builds_its_smoke_lm(arch):
    """Every config's smoke LM builds on the CPU with the JAX LM's stage
    count and parameter count, its cache has the JAX cache's leaf shapes,
    and a prefill gives finite logits."""
    cfg = get_config(arch).smoke()
    lm = LM(port_config(arch).smoke(), device="cpu")
    lm.init(torch.Generator().manual_seed(0))
    jlm = JaxLM(cfg)
    assert lm.n_stages == jlm.n_stages
    shapes = jax.eval_shape(jlm.init, jax.random.key(0))
    assert sum(p.numel() for p in lm.parameters()) == sum(
        x.size for x in jax.tree.leaves(shapes))
    cache = lm.init_cache(2, 16)
    want = jax.tree.leaves(jax.eval_shape(lambda: jlm.init_cache(2, 16)))
    assert [tuple(t.shape) for t in _cache_leaves(cache)] == \
        [w.shape for w in want]
    logits, _ = lm.prefill(cache, np.ones((2, 8), np.int32),
                           np.array([8, 3], np.int32))
    assert logits.shape == (2, cfg.vocab_padded)
    assert torch.isfinite(logits).all()


def test_apply_with_a_modality_prefix_matches_jax():
    """internvl2-1b (vlm): precomputed patch embeddings go through
    prefix_proj in front of the tokens; logits cover the tokens only."""
    cfg = get_config("internvl2-1b").smoke()
    jlm = JaxLM(cfg)
    params = jlm.init(jax.random.key(3))
    lm = LM(port_config("internvl2-1b").smoke(), device="cpu")
    lm.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                         params)))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    prefix = rng.normal(size=(2, cfg.prefix_len, cfg.prefix_dim)) \
        .astype(np.float32)
    want, _ = jlm.apply(params, jnp.asarray(toks),
                        prefix_embed=jnp.asarray(prefix))
    got, _ = lm.apply(toks, prefix_embed=prefix)
    assert got.shape == (2, 12, cfg.vocab_padded)
    _close_logits(got, want)


def test_init_draws_the_jax_distributions():
    """LM.init draws each parameter from the JAX init's distribution (not
    its values: the generators differ): per tensor the same std within 10%,
    the truncated normals inside +-2 x scale, norms at one."""
    cfg = get_config("granite-moe-1b-a400m").smoke()
    jparams = jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.key(0)))
    want = from_jax_params(cfg, jparams)
    lm = LM(port_config(cfg.name).smoke(), device="cpu")
    lm.init(torch.Generator().manual_seed(0))
    for name, p in lm.state_dict().items():
        w = want[name]
        assert p.dtype == w.dtype and p.shape == w.shape
        if name.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p))
            continue
        assert abs(p.std().item() / w.std().item() - 1) < 0.1, name
        if not name.startswith("embed"):      # truncated at 2 x scale
            assert p.abs().max() <= w.abs().max() * 1.05, name
    # the layer initialisers on their own
    g = torch.Generator().manual_seed(1)
    assert common.dense_init(g, 256, 64).w.abs().max() <= 2 * 256 ** -0.5
    assert abs(common.embed_init(g, 512, 64).w.std().item()
               - 64 ** -0.5) < 0.01
    assert set(moe.moe_init(g, cfg).state_dict()) == {
        "router.w", "wi", "wg", "wo"}
    assert set(attention.attn_init(g, cfg).state_dict()) == {
        "wq.w", "wk.w", "wv.w", "wo.w"}
    assert set(mlp.mlp_init(g, 8, 16, gated=False, n_layers=2)
               .state_dict()) == {"wi.w", "wo.w"}
