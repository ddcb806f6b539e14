"""The port's attention on the CPU against the JAX package: the flash
kernel's plain version against ``flash_attention_pallas`` (interpret mode,
as tests/test_kernels.py runs it) and ``ref.flash_attention_ref`` at that
file's shapes and tolerances (2e-5 in float32, 3e-2 in bfloat16); its
length form (right-padded prompts given by their lengths) against the
model's ``chunked_attention``; and the layers ``attn_prefill``/``attn_decode`` against JAX's, with
the same parameters, outputs and caches within 1e-5. The CUDA kernels'
tile plan (``flash_attention.tile_plan``) is held against the plain
version's mask, and the wrapper's checks of dtype and prompt lengths run
here; the kernels themselves, and their own tile rule, are held against
these on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
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
    """Right-padded prompts as prefill passes them, by their lengths: the
    JAX model's kv_pos = -1 on padding, q_pos = max(pos, 0), so a padded
    query sees key 0 only."""
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
        lengths=torch.from_numpy(lens)).transpose(1, 2)
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
                                     lengths=torch.from_numpy(lens),
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


def _admitted(s, length, causal, window):
    """(S, S) bool: the (query, key) pairs that the plain version's
    position mask lets through for a sequence of real length ``length``
    right-padded to ``s`` (the index form when ``length == s``). Read off
    the plain version itself: with q = 0 every admitted key of a row gets
    the same weight and a masked one exactly 0, so V = I returns the
    weights."""
    q = torch.zeros(1, 1, s, 8)
    w = ops.flash_attention(q, q, torch.eye(s)[None, None], causal=causal,
                            window=window, lengths=torch.tensor([length]))
    return (w[0, 0] > 0).numpy()


@settings(max_examples=80, deadline=None)
@given(s=st.integers(1, 700), length=st.integers(1, 700),
       causal=st.booleans(), window=st.one_of(st.none(), st.integers(1, 300)),
       block_q=st.sampled_from([64, 128]), block_k=st.sampled_from([64, 128]))
@example(s=200, length=200, causal=True, window=66, block_q=64, block_k=64)
@example(s=300, length=130, causal=True, window=3, block_q=128, block_k=64)
@example(s=129, length=1, causal=False, window=None, block_q=64, block_k=64)
def test_tile_plan_covers_the_mask_and_skips_the_rest(s, length, causal,
                                                      window, block_q,
                                                      block_k):
    """``flash_attention.tile_plan``, the rule both CUDA kernels follow,
    against the plain version's mask: every admitted (query, key) pair lies
    in a visited KV tile; no visited tile starts at or past the real length
    L; for a query tile of real rows only, no visited tile lies wholly
    outside the causal window. In fact every visited tile holds an admitted
    pair of the block, and tile 0 comes first where padded rows need it.
    L is drawn beyond S as often as not, which gives the index form."""
    length = min(length, s)
    mask = _admitted(s, length, causal, window)
    for q0 in range(0, s, block_q):
        plan = flash.tile_plan(q0, block_q, block_k, s, length, causal,
                               window)
        rows = mask[q0:q0 + block_q]
        needed = {j // block_k * block_k for j in np.flatnonzero(rows.any(0))}
        assert len(plan) == len(set(plan))
        assert needed <= set(plan)
        assert all(k0 < length for k0 in plan)
        assert all(rows[:, k0:k0 + block_k].any() for k0 in plan)
        if max(q0, length) < min(q0 + block_q, s):   # padded rows
            assert plan[0] == 0


def test_flash_padded_query_output_is_v_row0():
    """The identity the bfloat16 kernel's wholly padded causal tiles use: a
    padded query sees key 0 alone, with weight exactly 1, so its output is
    V's row 0 to the bit (soft-cap and window included)."""
    b, h, kv, s, hd = 2, 4, 2, 70, 16
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(9, b, h, kv, s, hd)))
    lens = torch.tensor([1, 40])
    out = ops.flash_attention(q, k, v, window=16, softcap=5.0, lengths=lens)
    v0 = v[:, :, :1].repeat_interleave(h // kv, dim=1)
    for i, n in enumerate(lens.tolist()):
        assert torch.equal(out[i, :, n:], v0[i].expand(h, s - n, hd))


def _cpu_qkv(dtype):
    return [x.to(dtype) for x in _t(*_qkv(0, 1, 2, 1, 8, 8))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_for_dtype(dtype):
    """bfloat16 (the tensor-core kernel) and float32 (the FMA kernel) pass
    the CUDA wrapper's type check and stop only at its device check: on a
    CPU tensor it raises and launches nothing."""
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        flash.flash_attention_cuda(*_cpu_qkv(dtype))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_flash_kernel_for_other_dtypes_raises(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash.flash_attention_cuda(*_cpu_qkv(dtype))


@pytest.mark.parametrize("lengths,error,match", [
    ([0, 8], ValueError, r"\[1, S = 8\]"),
    ([9, 8], ValueError, r"\[1, S = 8\]"),
    ([-1, 3], ValueError, r"\[1, S = 8\]"),
    ([8], ValueError, r"\(B,\)"),
    ([[8, 8]], ValueError, r"\(B,\)"),
    ([8.0, 8.0], TypeError, "integers")])
def test_flash_lengths_are_checked(lengths, error, match):
    """The length form takes (B,) integers in [1, S]: the plain version
    refuses anything else, as the CUDA wrapper does by the same check
    (``ref.check_lengths``, which reads a CPU tensor's values)."""
    q, k, v = _t(*_qkv(0, 2, 2, 1, 8, 8))
    with pytest.raises(error, match=match):
        ops.flash_attention(q, k, v, lengths=torch.tensor(lengths))


def test_flash_lengths_match_positions():
    """``lengths`` is the plain version's position mask of right-padded
    prompts, to the bit; giving both forms is refused."""
    q, k, v = _t(*_qkv(4, 3, 4, 2, 90, 16))
    lens = torch.tensor([90, 1, 64])
    q_pos, kv_pos = ref.prefill_positions(lens, 90)
    assert torch.equal(kv_pos[1], torch.tensor([0] + [-1] * 89,
                                                dtype=torch.int32))
    for window in (None, 20):
        got = ops.flash_attention(q, k, v, window=window, lengths=lens)
        want = ref.flash_attention_ref(q, k, v, window=window,
                                           q_positions=q_pos,
                                           kv_positions=kv_pos)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not both"):
        ref.flash_attention_ref(q, k, v, lengths=lens, q_positions=q_pos,
                                    kv_positions=kv_pos)
