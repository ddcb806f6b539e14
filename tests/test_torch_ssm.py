"""The port's Mamba block on the CPU against the JAX package: the selective
scan's plain version (``mamba_scan_ref``) against the JAX package's
``mamba_scan_ref`` and ``mamba_scan_pallas`` (interpret mode, as
tests/test_kernels.py runs it) in the kernel's (B, S, N, di) layout, at that
file's tolerance, rtol and atol 1e-4 (the scans sum in other orders); the
chunked scan against ``selective_scan_chunked``; ``ssm_train``,
``ssm_prefill`` (right-padded, conv tail and state included) and
``ssm_decode`` against the JAX functions with the same parameters, within
1e-5 (float32 on both sides); and the ``Mamba`` init's distributions against
``ssm_init``'s. The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm
from repro_torch.models.common import param_tree

SCAN_TOL = 1e-4
LAYER_TOL = 1e-5


def _scan_inputs(seed, b, s, n, di, lo=0.6):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, 1.0, size=(b, s, n, di)).astype(np.float32),
            rng.normal(size=(b, s, n, di)).astype(np.float32))


@pytest.mark.parametrize("s,di,bt,bd", [(64, 128, 16, 128), (70, 36, 16, 16),
                                        (1, 64, 8, 64)])
def test_mamba_scan_plain_matches_pallas(s, di, bt, bd):
    da, dbx = _scan_inputs(s + di, 2, s, 4, di)
    want = mamba_scan_pallas(jnp.asarray(da), jnp.asarray(dbx), block_t=bt,
                             block_d=bd)
    want_ref = jref.mamba_scan_ref(jnp.asarray(da), jnp.asarray(dbx))
    got = ops.mamba_scan(torch.from_numpy(da), torch.from_numpy(dbx))
    assert got.dtype == torch.float32 and got.shape == da.shape
    for w in (want, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


def test_mamba_scan_plain_bf16_inputs_and_padding():
    """bf16 inputs are scanned in float32; padded steps (da = 1, dbx = 0)
    carry the state, so the last step holds the state of the last real
    one."""
    da, dbx = _scan_inputs(5, 3, 40, 16, 24)
    lens = np.array([40, 1, 17])
    pad = np.arange(40)[None, :] >= lens[:, None]
    da[pad] = 1.0
    dbx[pad] = 0.0
    jda, jdbx = jnp.asarray(da, jnp.bfloat16), jnp.asarray(dbx, jnp.bfloat16)
    want = mamba_scan_pallas(jda, jdbx, block_t=16, block_d=8)
    tda, tdbx = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                 .to(torch.bfloat16) for x in (jda, jdbx))
    got = ops.mamba_scan(tda, tdbx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(got[i, -1].numpy(),
                                      got[i, n - 1].numpy())


def test_mamba_scan_plain_carries_an_initial_state():
    da, dbx = _scan_inputs(9, 2, 50, 4, 16)
    h0 = np.random.default_rng(10).normal(size=(2, 4, 16)).astype(np.float32)
    whole = ref.mamba_scan_ref(torch.from_numpy(da), torch.from_numpy(dbx),
                               torch.from_numpy(h0))
    first = ref.mamba_scan_ref(torch.from_numpy(da[:, :20]),
                               torch.from_numpy(dbx[:, :20]),
                               torch.from_numpy(h0))
    rest = ref.mamba_scan_ref(torch.from_numpy(da[:, 20:]),
                              torch.from_numpy(dbx[:, 20:]), first[:, -1])
    np.testing.assert_allclose(torch.cat([first, rest], 1).numpy(),
                               whole.numpy(), rtol=1e-6, atol=1e-6)
    # h0 enters as a step before t = 0
    want = np.asarray(jref.mamba_scan_ref(
        jnp.asarray(np.concatenate([np.ones_like(da[:, :1]), da], 1)),
        jnp.asarray(np.concatenate([h0[:, None], dbx], 1))))[:, 1:]
    np.testing.assert_allclose(whole.numpy(), want, rtol=SCAN_TOL,
                               atol=SCAN_TOL)


@pytest.mark.parametrize("s,chunk,with_h0", [(48, 16, False), (50, 16, True),
                                             (7, 256, False)])
def test_selective_scan_chunked_matches_jax(s, chunk, with_h0):
    rng = np.random.default_rng(s)
    b, di, n = 2, 32, 4
    da = rng.uniform(0.5, 1.0, size=(b, s, di, n)).astype(np.float32)
    dbx = rng.normal(size=(b, s, di, n)).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32) if with_h0 else None
    want_h, want_last = jssm.selective_scan_chunked(
        jnp.asarray(da), jnp.asarray(dbx),
        None if h0 is None else jnp.asarray(h0), chunk=chunk)
    got_h, got_last = ssm.selective_scan_chunked(
        torch.from_numpy(da), torch.from_numpy(dbx),
        None if h0 is None else torch.from_numpy(h0), chunk=chunk)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(val))
    return out


@pytest.fixture(scope="module")
def block():
    cfg = get_config("falcon-mamba-7b").smoke()
    params = jssm.ssm_init(jax.random.key(1), cfg)
    # a non-zero conv bias, so the conv's bias path is compared too
    params["conv_b"] = jnp.asarray(
        np.random.default_rng(1).normal(size=cfg.d_inner) * 0.1,
        jnp.float32)
    layer = ssm.Mamba(cfg)
    layer.load_state_dict(_flat(params))
    return cfg, params, param_tree(layer)


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_ssm_train_matches_jax(block):
    cfg, params, p = block
    x = np.random.default_rng(3).normal(size=(2, 40, cfg.d_model)) \
        .astype(np.float32)
    want = jssm.ssm_train(params, jnp.asarray(x), cfg, chunk=16)
    got = ssm.ssm_train(p, torch.from_numpy(x), cfg)
    _close(got, want)


def test_ssm_prefill_then_decode_match_jax(block):
    cfg, params, p = block
    b, s = 4, 24
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    lens = np.array([24, 1, 13, 2], np.int32)       # 1 and 2 < K - 1 = 3
    mask = np.arange(s)[None, :] < lens[:, None]
    jcache = jssm.SSMCache.zeros(b, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv)
    y_j, c_j = jssm.ssm_prefill(params, jnp.asarray(x), cfg, jcache,
                                mask=jnp.asarray(mask), chunk=8)
    cache = ssm.SSMCache.zeros(b, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv)
    y, out = ssm.ssm_prefill(p, torch.from_numpy(x), cfg, cache,
                             mask=torch.from_numpy(mask))
    assert out is cache                               # written in place
    _close(y, y_j)
    _close(cache.state, c_j.state)
    _close(cache.conv, c_j.conv)
    for _ in range(3):
        x1 = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        y_j, c_j = jssm.ssm_decode(params, jnp.asarray(x1), cfg, c_j)
        y, cache = ssm.ssm_decode(p, torch.from_numpy(x1), cfg, cache)
        _close(y, y_j)
        _close(cache.state, c_j.state)
        _close(cache.conv, c_j.conv)


def test_ssm_prefill_on_bf16_compute_matches_jax(block):
    """bf16 activations and caches, float32 dt_proj: the JAX package's
    mixed precision, within bf16 rounding."""
    cfg, params, p = block
    b, s = 2, 16
    x = np.random.default_rng(5).normal(size=(b, s, cfg.d_model))
    mask = np.arange(s)[None, :] < np.array([16, 9])[:, None]
    jx = jnp.asarray(x, jnp.bfloat16)
    y_j, c_j = jssm.ssm_prefill(
        params, jx, cfg, jssm.SSMCache.zeros(b, cfg.d_inner, cfg.ssm_state,
                                             cfg.ssm_conv, jnp.bfloat16),
        mask=jnp.asarray(mask))
    cache = ssm.SSMCache.zeros(b, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                               torch.bfloat16)
    y, cache = ssm.ssm_prefill(
        p, torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16(),
        cfg, cache, mask=torch.from_numpy(mask))
    assert y.dtype == torch.bfloat16 and cache.state.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(y_j, np.float32)).max())
    assert np.abs(y.float().numpy() - np.asarray(y_j, np.float32)).max() \
        <= 3e-2 * scale


def test_mamba_init_draws_ssm_init_distributions():
    """Not the values (the generators differ): ``A_log``, ``D`` and
    ``conv_b`` exactly, dt = softplus(dt_bias) inside [1e-3, 1e-1] and
    log-uniform, the projections' std within 10% and their truncation."""
    cfg = get_config("falcon-mamba-7b").smoke()
    want = jax.tree.map(np.asarray, jssm.ssm_init(jax.random.key(0), cfg))
    got = ssm.ssm_init(torch.Generator().manual_seed(0), cfg)
    tree = {k: v.numpy() for k, v in got.state_dict().items()}
    assert set(tree) == set(_flat(want))
    for name in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(tree[name], want[name], rtol=1e-6)
    dt = np.log1p(np.exp(tree["dt_bias"]))
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
    log_dt = np.log(dt)           # uniform on [log 1e-3, log 1e-1]
    assert abs(log_dt.mean() - np.log(1e-2)) < 0.3
    assert abs(log_dt.std() / (np.log(100) / 12 ** 0.5) - 1) < 0.15
    assert tree["dt_bias"].dtype == np.float32
    for name, w in (("conv_w", want["conv_w"]),
                    ("in_proj.w", want["in_proj"]["w"]),
                    ("x_proj.w", want["x_proj"]["w"]),
                    ("dt_proj.w", want["dt_proj"]["w"]),
                    ("out_proj.w", want["out_proj"]["w"])):
        assert tree[name].shape == w.shape, name
        assert abs(tree[name].std() / w.std() - 1) < 0.1, name
        if name != "conv_w":                # truncated at 2 x scale
            assert np.abs(tree[name]).max() <= np.abs(w).max() * 1.05, name


def test_mamba_scan_wrapper_on_cpu_launches_nothing():
    before = ops.launch_counts()
    da, dbx = _scan_inputs(0, 1, 3, 2, 4)
    ops.mamba_scan(torch.from_numpy(da), torch.from_numpy(dbx))
    assert ops.launch_counts() == before
