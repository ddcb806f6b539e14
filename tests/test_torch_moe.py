"""The port's MoE path on the CPU against the JAX package: the expert-
dispatch positions (plain version of the CUDA kernel) against
``dispatch_positions_pallas`` (interpret mode), ``ref.dispatch_positions_ref``
and ``moe_dispatch._positions_in_expert``, exactly; ``dispatch`` for both
position methods with rebalance on and off, on logits that overflow
capacity (expert_idx, slot_idx and keep equal, weight within 1e-6); and
``moe_apply`` in both modes within 1e-5, with the same parameters."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.kernels.psts_dispatch import dispatch_positions_pallas
from repro.models import moe as jmoe
from repro.sched import moe_dispatch as jdisp
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.common import param_tree
from repro_torch.sched import moe_dispatch as disp


@pytest.mark.parametrize("t,e,bt", [(64, 4, 32), (533, 6, 128),
                                    (100, 32, 64), (8, 128, 8)])
def test_dispatch_positions_plain_matches_pallas_exactly(t, e, bt):
    """Three rows at once (the port batches token groups), each equal to
    the Pallas kernel's single row, with -1 tokens and non-zero base."""
    rng = np.random.default_rng(t + e)
    idx = rng.integers(-1, e, size=(3, t)).astype(np.int32)
    base = rng.integers(0, 3, size=(3, e)).astype(np.int32)
    pos, fill = ops.dispatch_positions(torch.from_numpy(idx),
                                       torch.from_numpy(base), e)
    assert pos.dtype == torch.int32 and fill.dtype == torch.int32
    for r in range(3):
        want_p, want_f = dispatch_positions_pallas(
            jnp.asarray(idx[r]), jnp.asarray(base[r]), n_experts=e,
            block_tokens=bt)
        ref_p, ref_f = jref.dispatch_positions_ref(
            jnp.asarray(idx[r]), jnp.asarray(base[r]), e)
        for want in (want_p, ref_p):
            np.testing.assert_array_equal(pos[r].numpy(), np.asarray(want))
        for want in (want_f, ref_f):
            np.testing.assert_array_equal(fill[r].numpy(), np.asarray(want))
        onehot = jax.nn.one_hot(idx[r], e, dtype=jnp.int32)
        layer = jdisp._positions_in_expert(onehot, jnp.asarray(base[r]))
        np.testing.assert_array_equal(pos[r].numpy(), np.asarray(layer))


def test_dispatch_positions_plain_edges():
    # the paper's load scan S on the JAX tests' example
    pos, fill = ops.dispatch_positions(
        torch.tensor([[2, 0, 2, 2, 1, 0]], dtype=torch.int32),
        torch.tensor([[10, 0, 5]], dtype=torch.int32), 3)
    assert pos.tolist() == [[5, 10, 6, 7, 0, 11]]
    assert fill.tolist() == [[12, 1, 8]]
    # all tokens without an expert, out-of-range experts, E beyond 128
    pos, fill = ops.dispatch_positions(
        torch.tensor([[-1, -1], [7, 200]], dtype=torch.int32),
        torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32), 3)
    assert pos.tolist() == [[0, 0], [0, 0]]
    assert fill.tolist() == [[1, 2, 3], [4, 5, 6]]
    idx = torch.tensor([[299, 0, 299, 130]], dtype=torch.int32)
    pos, fill = ops.dispatch_positions(idx, torch.zeros((1, 300),
                                                        dtype=torch.int32),
                                       300)
    assert pos.tolist() == [[0, 0, 1, 0]]
    assert fill[0, 299] == 2 and fill[0, 130] == 1 and fill.sum() == 4


def _logits(t, e, seed, skew=2.5):
    """Router logits skewed towards a few experts, so slots overflow."""
    rng = np.random.default_rng(seed)
    bias = np.linspace(skew, 0.0, e)
    return (rng.normal(size=(t, e)) + bias).astype(np.float32)


@pytest.mark.parametrize("method", ["scan", "sort"])
@pytest.mark.parametrize("rebalance", [True, False])
def test_dispatch_matches_jax(method, rebalance):
    t, e, k, cap = 96, 8, 2, 16
    logits = _logits(t, e, seed=11)
    want = jdisp.dispatch(jnp.asarray(logits), k=k, capacity=cap,
                          rebalance=rebalance, position_method=method)
    got = disp.dispatch(torch.from_numpy(logits), k=k, capacity=cap,
                        rebalance=rebalance, position_method=method)
    assert int(want.aux["overflow"]) > 0            # capacity is exceeded
    for name in ("expert_idx", "slot_idx", "keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=1e-6, atol=1e-6)
    for name in ("overflow", "rebalanced", "dropped"):
        assert int(got.aux[name]) == int(want.aux[name])
    for name in ("top1_load", "mean_prob"):
        np.testing.assert_allclose(got.aux[name].numpy(),
                                   np.asarray(want.aux[name]), rtol=1e-6)
    tok, valid = got.slot_to_token()
    want_tok, want_valid = want.slot_to_token()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(tok.numpy()[valid.numpy()],
                                  np.asarray(want_tok)[np.asarray(want_valid)])
    for g, w in zip(got.dense(), want.dense()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_dispatch_grouped_matches_jax_vmap():
    g, t, e, k, cap = 3, 40, 6, 3, 16
    logits = np.stack([_logits(t, e, seed=s) for s in range(g)])
    want = jdisp.dispatch_grouped(jnp.asarray(logits), k=k, capacity=cap)
    got = disp.dispatch_grouped(torch.from_numpy(logits), k=k, capacity=cap)
    for name in ("expert_idx", "slot_idx", "keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=1e-6, atol=1e-6)


def test_scan_fill_is_kernel_fill_capped_at_capacity():
    """_positions_scan keeps min(fill, C) per expert: the count of kept
    token-slots, as the JAX loop's filled += sum(onehot * (pos < C))."""
    topk = torch.from_numpy(np.random.default_rng(3).integers(
        0, 5, size=(2, 50, 3)).astype(np.int32))
    slot, keep, filled = disp._positions_scan(topk, 5, 12)
    for gi in range(2):
        kept = torch.bincount(topk[gi][keep[gi]].long(), minlength=5)
        assert torch.equal(filled[gi].long(), kept)
        _, _, want = jdisp._positions_scan(jnp.asarray(topk[gi].numpy()),
                                           5, 12)
        np.testing.assert_array_equal(filled[gi].numpy(), np.asarray(want))


def test_router_aux_loss_matches_jax():
    logits = _logits(64, 8, seed=4).reshape(2, 32, 8)
    want = jdisp.router_aux_loss(jnp.asarray(logits), 2)
    got = disp.router_aux_loss(torch.from_numpy(logits), 2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("mode", ["scatter", "einsum"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_apply_matches_jax(mode, capacity_factor):
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").smoke(),
                              capacity_factor=capacity_factor)
    params = jmoe.moe_init(jax.random.key(2), cfg)
    # steer every token towards experts 0 and 1, so slots overflow
    u = np.ones(cfg.d_model, np.float32) / np.sqrt(cfg.d_model)
    w = np.array(params["router"]["w"])
    w[:, 0] += 2.0 * u
    w[:, 1] += 1.5 * u
    params["router"]["w"] = jnp.asarray(w)
    layer = moe.MoE(cfg)
    layer.load_state_dict({"router.w": torch.from_numpy(
        np.array(params["router"]["w"]))} | {
        n: torch.from_numpy(np.array(params[n]))
        for n in ("wi", "wg", "wo")})
    x = (np.random.default_rng(6).normal(size=(3, 40, cfg.d_model))
         + 2.0 * u).astype(np.float32)
    want, want_aux = jmoe.moe_apply(params, jnp.asarray(x), cfg, mode=mode)
    got, aux = moe.moe_apply(param_tree(layer), torch.from_numpy(x), cfg,
                             mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name in ("overflow", "rebalanced", "dropped"):
        assert int(aux[name]) == int(want_aux[name])
    if capacity_factor == 1.25:
        assert int(want_aux["overflow"]) > 0


def test_moe_capacity_matches_jax():
    for args in [(1, 8, 32, 1.25), (2048, 8, 32, 1.25), (40, 2, 4, 8.0),
                 (7, 1, 3, 1.0)]:
        assert moe.moe_capacity(*args) == jmoe.moe_capacity(*args)
