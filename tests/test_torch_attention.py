"""The port's attention on the CPU against the JAX package: the flash
kernel's plain version against ``flash_attention_pallas`` (interpret mode,
as tests/test_kernels.py runs it) and ``ref.flash_attention_ref`` at that
file's shapes and tolerances (2e-5 in float32, 3e-2 in bfloat16); its
position form against the model's ``chunked_attention`` on right-padded
keys; and the layers ``attn_prefill``/``attn_decode`` against JAX's, with
the same parameters, outputs and caches within 1e-5. The CUDA kernel itself
is held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import param_tree

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(seed, b, h, kv, s, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, hd)).astype(np.float32),
            rng.normal(size=(b, kv, s, hd)).astype(np.float32),
            rng.normal(size=(b, kv, s, hd)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("h,kv,s,hd", [(4, 4, 128, 32), (4, 2, 130, 64),
                                       (8, 1, 96, 32)])
def test_flash_plain_matches_pallas_gqa(h, kv, s, hd):
    q, k, v = _qkv(h * s, 2, h, kv, s, hd)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=64, block_k=64)
    want_ref = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    got = ops.flash_attention(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got, np.asarray(want_ref), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("softcap", [None, 8.0])
def test_flash_plain_window_softcap_match_pallas(window, softcap):
    q, k, v = _qkv(3, 1, 2, 2, 128, 32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  softcap=softcap, block_q=32, block_k=32)
    got = ops.flash_attention(*_t(q, k, v), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_plain_bf16_matches_pallas():
    q, k, v = _qkv(4, 1, 2, 2, 64, 32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (jq, jk, jv))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("window,is_global", [(None, True), (24, False)])
def test_flash_position_form_matches_chunked_attention(window, is_global):
    """Right-padded prompts as prefill passes them: kv_pos = -1 on padding,
    q_pos = max(pos, 0), so a padded query sees key 0 only."""
    b, s, h, kv, hd = 3, 70, 4, 2, 32
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    lens = np.array([70, 1, 33])
    pos = np.broadcast_to(np.arange(s), (b, s))
    kv_pos = np.where(pos < lens[:, None], pos, -1).astype(np.int32)
    q_pos = np.maximum(kv_pos, 0)
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
        window=window, is_global=is_global, block=32)
    tq, tk, tv = _t(q, k, v)
    got = ops.flash_attention(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        window=None if is_global else window,
        q_positions=torch.from_numpy(q_pos),
        kv_positions=torch.from_numpy(kv_pos)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    port = attn.chunked_attention(
        tq, tk, tv, q_positions=torch.from_numpy(q_pos),
        kv_positions=torch.from_numpy(kv_pos), window=window,
        is_global=is_global)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def _layer_pair(cfg):
    params = jattn.attn_init(jax.random.key(1), cfg)
    layer = attn.Attention(cfg)
    layer.load_state_dict({f"{n}.{leaf}": torch.from_numpy(np.array(x))
                           for n, d in params.items()
                           for leaf, x in d.items()})
    return params, param_tree(layer)


@pytest.mark.parametrize("arch,window", [("granite-moe-1b-a400m", None),
                                         ("gemma3-4b", 8)])
def test_attn_prefill_and_decode_match_jax(arch, window):
    cfg = get_config(arch).smoke()
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    params, p = _layer_pair(cfg)
    b, s, max_len = 3, 24, 32
    rng = np.random.default_rng(2)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    lens = np.array([24, 5, 13], np.int32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    positions = np.where(pos < lens[:, None], pos, -1).astype(np.int32)
    for is_global in (True, False):
        y_j, c_j = jattn.attn_prefill(
            params, jnp.asarray(x), cfg,
            jattn.KVCache.zeros(b, max_len, cfg.n_kv_heads, cfg.head_dim_,
                                jnp.float32),
            positions=jnp.asarray(positions), is_global=is_global)
        cache = attn.KVCache.zeros(b, max_len, cfg.n_kv_heads,
                                   cfg.head_dim_, torch.float32)
        y, cache = attn.attn_prefill(p, torch.from_numpy(x), cfg, cache,
                                     positions=torch.from_numpy(positions),
                                     is_global=is_global)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5,
                                   atol=1e-5)
        for got, want in zip(cache, c_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        x1 = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        y_j, c_j = jattn.attn_decode(params, jnp.asarray(x1), cfg, c_j,
                                     jnp.asarray(lens), is_global=is_global)
        y, cache = attn.attn_decode(p, torch.from_numpy(x1), cfg, cache,
                                    torch.from_numpy(lens).long(),
                                    is_global=is_global)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5,
                                   atol=1e-5)
        for got, want in zip(cache, c_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_attn_train_matches_jax():
    cfg = get_config("olmo-1b").smoke()
    params, p = _layer_pair(cfg)
    x = np.random.default_rng(3).normal(size=(2, 40, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    want = jattn.attn_train(params, jnp.asarray(x), cfg,
                            positions=jnp.asarray(pos))
    got = attn.attn_train(p, torch.from_numpy(x), cfg,
                          positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_wrapper_on_cpu_launches_nothing():
    before = ops.launch_counts()
    q, k, v = _t(*_qkv(0, 1, 2, 1, 8, 8))
    ops.flash_attention(q, k, v)
    ops.dispatch_positions(torch.zeros((1, 3), dtype=torch.int32),
                           torch.zeros((1, 2), dtype=torch.int32), 2)
    assert ops.launch_counts() == before
