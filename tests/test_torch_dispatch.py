"""The MoE expert-dispatch positions over k priority levels on the CPU
(``ops.dispatch_positions_levels``, the plain version of the levels kernel)
against the JAX package, exactly: its ``sched.moe_dispatch._positions_scan``
row by row, and k calls of ``dispatch_positions_pallas`` (interpret mode)
with the fill clamped to the capacity between them; and the MoE layer
through both position methods at granite's and jamba's smoke configs. The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import get_config
from repro.kernels.psts_dispatch import dispatch_positions_pallas
from repro.models import moe as jmoe
from repro.sched import moe_dispatch as jdisp
from repro_torch.kernels import ops
from repro_torch.kernels.psts_dispatch import dispatch_positions_levels_cuda
from repro_torch.models import moe
from repro_torch.models.common import param_tree
from repro_torch.sched import moe_dispatch as disp


def _topk(rng, r, t, k, e, frac_none):
    """(R, T, k) int32 experts, a share of them -1 (none)."""
    topk = rng.integers(0, e, size=(r, t, k))
    topk[rng.random((r, t, k)) < frac_none] = -1
    return topk.astype(np.int32)


@settings(max_examples=60, deadline=None)
@given(r=st.integers(1, 3), t=st.integers(0, 70), k=st.integers(1, 5),
       e=st.integers(1, 12), capacity=st.integers(0, 30),
       frac_none=st.sampled_from([0.0, 0.2, 1.0]),
       seed=st.integers(0, 2 ** 16))
@example(r=2, t=64, k=4, e=3, capacity=5, frac_none=0.0, seed=1)
@example(r=1, t=50, k=1, e=4, capacity=100, frac_none=0.1, seed=2)
def test_positions_levels_match_jax_positions_scan(r, t, k, e, capacity,
                                                   frac_none, seed):
    """Exact, row by row, against the JAX reference's slot-priority scan,
    capacities that overflow (the clamp between levels matters), experts of
    -1 and k = 1 included."""
    topk = _topk(np.random.default_rng(seed), r, t, k, e, frac_none)
    before = ops.launch_counts()
    slot, keep, filled = ops.dispatch_positions_levels(
        torch.from_numpy(topk), e, capacity)
    assert ops.launch_counts() == before          # the CPU launches nothing
    assert slot.dtype == torch.int32 and keep.dtype == torch.bool
    assert filled.dtype == torch.int32 and filled.shape == (r, e)
    for i in range(r):
        w_slot, w_keep, w_filled = jdisp._positions_scan(
            jnp.asarray(topk[i]), e, capacity)
        np.testing.assert_array_equal(slot[i].numpy(), np.asarray(w_slot))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(w_keep))
        np.testing.assert_array_equal(filled[i].numpy(),
                                      np.asarray(w_filled))


@pytest.mark.parametrize("t,k,e,capacity,bt", [(64, 3, 4, 10, 32),
                                               (533, 2, 6, 60, 128),
                                               (100, 8, 32, 20, 64),
                                               (40, 1, 128, 1, 8)])
def test_positions_levels_match_pallas_levels(t, k, e, capacity, bt):
    """Exact against k calls of the Pallas kernel, level s from the
    previous level's fill clamped to the capacity."""
    topk = _topk(np.random.default_rng(t * k + e), 2, t, k, e, 0.1)
    slot, keep, filled = ops.dispatch_positions_levels(
        torch.from_numpy(topk), e, capacity)
    for i in range(2):
        base = jnp.zeros(e, jnp.int32)
        for s in range(k):
            pos, fill = dispatch_positions_pallas(
                jnp.asarray(topk[i, :, s]), base, n_experts=e,
                block_tokens=bt)
            np.testing.assert_array_equal(slot[i, :, s].numpy(),
                                          np.asarray(pos))
            np.testing.assert_array_equal(keep[i, :, s].numpy(),
                                          np.asarray(pos) < capacity)
            base = jnp.minimum(fill, capacity)
        np.testing.assert_array_equal(filled[i].numpy(), np.asarray(base))


@pytest.mark.parametrize("capacity", [0, 3, 1000])
def test_scan_and_sort_position_methods_agree(capacity):
    """The two methods keep the same slots with the same positions and
    fill alike; they differ only in the positions of dropped slots (the
    sort counts every earlier choice, the scan from the clamped fill)."""
    topk = torch.from_numpy(_topk(np.random.default_rng(capacity), 3, 90, 4,
                                  7, 0.0))
    slot, keep, filled = disp._positions_scan(topk, 7, capacity)
    s_slot, s_keep, s_filled = disp._positions_sort(topk, 7, capacity)
    assert torch.equal(keep, s_keep) and torch.equal(filled, s_filled)
    assert torch.equal(slot[keep], s_slot[s_keep])


def test_levels_wrapper_refuses_what_the_kernel_does_not_take():
    topk = torch.zeros((2, 5, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        dispatch_positions_levels_cuda(topk, 4, 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.dispatch_positions_levels(
            SimpleNamespace(device=torch.device("xla")), 4, 2)
    # meta tensors (the dry run) get the plain version's shapes alone
    slot, keep, filled = ops.dispatch_positions_levels(topk.to("meta"), 4, 2)
    assert slot.shape == topk.shape and filled.shape == (2, 4)


@pytest.mark.parametrize("method", ["scan", "sort"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_moe_layer_position_methods_match_jax(arch, method):
    """The smoke MoE layer with each position method against the JAX
    layer on the same parameters, routing steered so that slots overflow:
    outputs within 1e-5, overflow / rebalanced / dropped counts equal."""
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              dispatch_positions=method, capacity_factor=1.0)
    params = jmoe.moe_init(jax.random.key(5), cfg)
    u = np.ones(cfg.d_model, np.float32) / np.sqrt(cfg.d_model)
    w = np.array(params["router"]["w"])
    w[:, 0] += 2.0 * u
    params["router"]["w"] = jnp.asarray(w)
    layer = moe.MoE(cfg)
    layer.load_state_dict({"router.w": torch.from_numpy(w)} | {
        n: torch.from_numpy(np.array(params[n])) for n in ("wi", "wg", "wo")})
    x = (np.random.default_rng(8).normal(size=(2, 48, cfg.d_model))
         + 2.0 * u).astype(np.float32)
    want, want_aux = jmoe.moe_apply(params, jnp.asarray(x), cfg)
    got, aux = moe.moe_apply(param_tree(layer), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name in ("overflow", "rebalanced", "dropped"):
        assert int(aux[name]) == int(want_aux[name])
    assert int(want_aux["overflow"]) > 0
