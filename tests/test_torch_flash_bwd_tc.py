"""The bfloat16 flash attention backward's tensor-core kernels
(``flash_bwd_dq_tc``, ``flash_bwd_dkdv_tc`` in
``repro_torch/kernels/csrc/flash_attention_bwd.cu``), checked on the CPU
where they cannot run:

* Their tile plan. ``flash_attention.bwd_tiles`` gives the query and key
  tiles at each head width; a dQ block walks the key tiles of
  ``tile_plan`` (index form), a dK/dV block the query tiles of
  ``bwd_key_plan``. Each walk must visit every (query, key) pair the mask
  admits exactly once, and no visited tile may lack an admitted pair. The
  card tests and ``chip_smoke.py`` hold the kernels' own rule (run on the
  host) against these statements.
* Their arithmetic, emulated in float32: inputs rounded to bf16, S and dP
  in float32, P = exp(S * scale - LSE), D = sum_j P dP in float32, dS in
  float32, then P and dS rounded to bf16 as the operands of the dV, dK and
  dQ products, float32 sums, bf16 outputs. Held against ``jax.grad`` of
  the JAX package's ``flash_attention_ref`` in float32 at the same rounded
  inputs, to the card's bounds (``chip_smoke.py`` phase 14a): 3e-2 per
  gradient row in relative L2 norm, over the rows whose norm is at least
  1e-3 of the largest, and 6e-2 per element (rtol and atol). One case shows
  why the kernels keep D = sum_j P dP: D taken from the forward's
  bf16-rounded output breaks the row bound where dP - D cancels.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as flash

ROW_TOL = 3e-2
ELEM_TOL = 6e-2


def _admitted(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= i >= j
    if window is not None:
        mask &= (i - j) < window
    return mask


@pytest.mark.parametrize("window", [None, 1, 16, 100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 700])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_tc_walks_visit_each_admitted_pair_once(hd, s, causal, window):
    bq, bk = flash.bwd_tiles(torch.bfloat16, hd)
    mask = _admitted(s, causal, window)
    dq_tiles, kv_tiles = set(), set()
    for name, tiles, walks in (
            ("dQ", dq_tiles,
             [(q0, k0) for q0 in range(0, s, bq)
              for k0 in flash.tile_plan(q0, bq, bk, s, s, causal, window)]),
            ("dK/dV", kv_tiles,
             [(q0, k0) for k0 in range(0, s, bk)
              for q0 in flash.bwd_key_plan(k0, bq, bk, s, causal, window)])):
        visits = np.zeros((s, s), np.int32)
        for q0, k0 in walks:
            assert (q0, k0) not in tiles, f"{name} visits {(q0, k0)} twice"
            tiles.add((q0, k0))
            block = mask[q0:q0 + bq, k0:k0 + bk]
            assert block.any(), f"{name} visits {(q0, k0)}, which sees nothing"
            visits[q0:q0 + bq, k0:k0 + bk] += 1
        assert (visits[mask] == 1).all(), f"{name} misses an admitted pair"
    assert dq_tiles == kv_tiles


def _bf16(x):
    """float32 values rounded to bf16, kept in float32."""
    return torch.as_tensor(x).to(torch.bfloat16).float()


def emulate_tc(q, k, v, dout, *, causal=True, window=None, softcap=None,
               d_from_output=False):
    """(dq, dk, dv) as the tensor-core kernels form them, in float32 on
    bf16-valued float32 inputs: q, dout (B, H, S, hd), k, v (B, KV, S, hd).
    ``d_from_output`` takes D = rowsum(dO * O) of the bf16-rounded output
    instead of sum_j P dP."""
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    rep = h // kvh
    scale = hd ** -0.5
    kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    qk = q @ kf.transpose(-1, -2)
    mask = torch.from_numpy(_admitted(s, causal, window))
    t = None
    if softcap is not None:
        t = torch.tanh(qk * (scale / softcap))
        logit = softcap * t
    else:
        logit = qk * scale
    lse = torch.logsumexp(torch.where(mask, logit, -2.0 ** 30), -1,
                          keepdim=True)
    p = torch.where(mask, torch.exp(logit - lse), 0.0)
    dp = dout @ vf.transpose(-1, -2)
    if d_from_output:
        d = (dout * _bf16(p @ vf)).sum(-1, keepdim=True)
    else:
        d = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - d)
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    p16, ds16 = _bf16(p), _bf16(ds)
    dq = ds16 @ kf
    dk = (ds16.transpose(-1, -2) @ q).reshape(b, kvh, rep, s, hd).sum(2)
    dv = (p16.transpose(-1, -2) @ dout).reshape(b, kvh, rep, s, hd).sum(2)
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _inputs(seed, b, h, kvh, s, hd):
    rng = np.random.default_rng(seed)
    q, dout = (_bf16(rng.normal(size=(b, h, s, hd)).astype(np.float32))
               for _ in range(2))
    k, v = (_bf16(rng.normal(size=(b, kvh, s, hd)).astype(np.float32))
            for _ in range(2))
    return q, k, v, dout


def _jax_grads(q, k, v, dout, **kw):
    dn = dout.numpy()

    def f(q, k, v):
        return jnp.vdot(jref.flash_attention_ref(q, k, v, **kw), dn)
    grads = jax.grad(f, argnums=(0, 1, 2))(q.numpy(), k.numpy(), v.numpy())
    return [np.asarray(g) for g in grads]


def _row_err(got, want):
    """The worst relative L2 error over the rows whose norm is at least
    1e-3 of the largest (0 without such a row)."""
    norms = np.linalg.norm(want, axis=-1)
    rows = (norms > 0) & (norms >= 1e-3 * norms.max())
    if not rows.any():
        return 0.0
    return float((np.linalg.norm(got - want, axis=-1)[rows]
                  / norms[rows]).max())


@pytest.mark.parametrize("s,window,softcap,rep,causal", [
    (1, None, None, 2, True),
    (65, None, None, 1, True),
    (65, None, None, 2, True),
    (65, None, None, 4, True),
    (65, 16, None, 2, True),
    (65, None, 30.0, 2, True),
    (65, 16, 30.0, 4, True),
    (130, None, None, 2, False)])
def test_tc_arithmetic_matches_jax_grad(s, window, softcap, rep, causal):
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, dout = _inputs(s + rep, 2, 2 * rep, 2, s, 64)
    want = _jax_grads(q, k, v, dout, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), emulate_tc(q, k, v, dout, **kw),
                          want):
        a = a.numpy()
        assert a.shape == w.shape
        assert _row_err(a, w) <= ROW_TOL, name
        assert (np.abs(a - w) <= ELEM_TOL + ELEM_TOL * np.abs(w)).all(), name


def test_d_from_the_bf16_output_breaks_the_row_bound():
    """Where dP - D cancels (a query that sees few keys), D from the
    bf16-rounded output puts dq rows off by more than the bound; D = sum_j
    P dP in float32 keeps them within it."""
    q, k, v, dout = _inputs(65, 2, 4, 2, 65, 64)
    want = _jax_grads(q, k, v, dout, causal=True)[0]
    kept = emulate_tc(q, k, v, dout)[0].numpy()
    from_o = emulate_tc(q, k, v, dout, d_from_output=True)[0].numpy()
    assert _row_err(kept, want) <= ROW_TOL
    assert _row_err(from_o, want) > ROW_TOL
