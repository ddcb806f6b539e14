"""The port's optimizer substrate against the JAX package's on the CPU:
AdamW with float32 and bfloat16 moments (weight decay decided by the rank a
leaf has in the JAX layout, where the stages are stacked), global_norm,
clip_by_global_norm, the three schedules and the int8 compression with
error feedback; plus the reference's own optimizer cases of
``tests/test_substrate.py``, mirrored on the port.

Tolerance: rtol 1e-6 on float results (both sides compute in float32, the
port per stage where the JAX package sums over the stacked stages), int8
codes equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim
from repro_torch.optim.adamw import jax_rank, tree_leaves

RTOL = 1e-6
N_STAGES = 3

# a parameter tree in the JAX layout: the stage leaves stacked on axis 0
SHAPES = {"embed": {"w": (16, 8)}, "final_norm": {"scale": (8,)},
          "stages": {"norm1": {"scale": (N_STAGES, 8)},
                     "attn": {"wq": {"w": (N_STAGES, 8, 8)}},
                     "mamba": {"D": (N_STAGES, 8),
                               "A_log": (N_STAGES, 8, 4)}}}


def _jax_tree(rng, shapes=SHAPES, scale=1.0):
    return {k: _jax_tree(rng, v, scale) if isinstance(v, dict) else
            rng.normal(size=v).astype(np.float32) * scale
            for k, v in shapes.items()}


def _port_tree(tree, dtype=torch.float32):
    """The JAX-layout tree as the port keeps it: stages split per stage."""
    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else
                torch.tensor(np.asarray(v, np.float32), dtype=dtype)
                for k, v in t.items()}
    out = conv({k: v for k, v in tree.items() if k != "stages"})
    stacked = conv(tree["stages"])

    def pick(t, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in t.items()}
    out["stages"] = {str(i): pick(stacked, i) for i in range(N_STAGES)}
    return out


def _assert_tree_close(port, jax_tree, rtol=RTOL):
    want = _port_tree(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   jax_tree))
    for got, w in zip(tree_leaves(port), tree_leaves(want)):
        np.testing.assert_allclose(got.float().numpy(), w.numpy(),
                                   rtol=rtol, atol=rtol * float(
                                       w.abs().max()))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_steps(moments):
    rng = np.random.default_rng(0)
    jparams = _jax_tree(rng)
    jo = jopt.AdamW(weight_decay=0.1, moments_dtype=getattr(jnp, moments))
    po = optim.AdamW(weight_decay=0.1, moments_dtype=getattr(torch, moments))
    jstate = jo.init(jparams)
    params = _port_tree(jparams)
    pstate = po.init(params)
    for step in range(5):
        grads = _jax_tree(rng, scale=0.3)
        lr = 1e-2 * (step + 1)
        jparams, jstate = jo.update(grads, jstate, jparams, lr)
        params, pstate = po.update(_port_tree(grads), pstate, params, lr)
    assert int(pstate.step) == int(jstate.step) == 5
    assert pstate.m["stages"]["0"]["norm1"]["scale"].dtype == \
        getattr(torch, moments)
    _assert_tree_close(params, jparams)
    _assert_tree_close(pstate.m, jstate.m)
    _assert_tree_close(pstate.v, jstate.v)


def test_decay_follows_the_jax_layouts_rank():
    """A stage's norm scale is 1-D here and (n_stages, d) in the JAX
    layout, so it is decayed, as the reference decays it; the final norm's
    scale is not."""
    params = _port_tree(_jax_tree(np.random.default_rng(1)))
    ranks = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                ranks[path + (k,)] = jax_rank(path + (k,), v)
    walk(params)
    assert ranks[("final_norm", "scale")] == 1
    assert ranks[("stages", "0", "norm1", "scale")] == 2
    assert ranks[("stages", "2", "attn", "wq", "w")] == 3
    opt = optim.AdamW(weight_decay=1.0)
    zero = {k: v for k, v in params.items()}
    zero = jax.tree.map(torch.zeros_like, zero)
    before = {k: v.clone() for k, v in (
        ("final", params["final_norm"]["scale"]),
        ("stage", params["stages"]["1"]["norm1"]["scale"]))}
    opt.update(zero, opt.init(params), params, lr=0.1)
    assert torch.equal(params["final_norm"]["scale"], before["final"])
    assert torch.allclose(params["stages"]["1"]["norm1"]["scale"],
                          before["stage"] * 0.9)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    tree = _jax_tree(rng, scale=4.0)
    port = _port_tree(tree)
    np.testing.assert_allclose(float(optim.global_norm(port)),
                               float(jopt.global_norm(tree)), rtol=RTOL)
    for max_norm in (1.0, 1e4):
        jclip, jnorm = jopt.clip_by_global_norm(tree, max_norm)
        pclip, pnorm = optim.clip_by_global_norm(port, max_norm)
        np.testing.assert_allclose(float(pnorm), float(jnorm), rtol=RTOL)
        _assert_tree_close(pclip, jclip)


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-3, 20, 100)),
    ("warmup_cosine", (1e-3, 0, 10, 0.0)),
    ("warmup_rsqrt", (2e-3, 10)),
    ("constant", (5e-4,))])
def test_schedules_match_jax(name, args):
    jsch, psch = getattr(jopt, name)(*args), getattr(optim, name)(*args)
    for step in range(0, 130, 3):
        want = float(jsch(step))
        got = psch(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=RTOL)
        np.testing.assert_allclose(
            float(psch(torch.tensor(step, dtype=torch.int32))), want,
            rtol=RTOL)


def test_compress_and_feedback_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 9)).astype(np.float32) * 3
    jq, js = jopt.compress(jnp.asarray(x))
    pq, ps = optim.compress(torch.from_numpy(x))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ps), float(js), rtol=RTOL)
    np.testing.assert_allclose(optim.decompress(pq, ps).numpy(),
                               np.asarray(jopt.decompress(jq, js)),
                               rtol=RTOL)
    grads = {"w": x, "b": {"c": x[:5, 0] * 1e-3}}
    jstate = jopt.init_state(grads)
    pstate = optim.init_state(jax.tree.map(torch.from_numpy, grads))
    for step in range(4):
        g = jax.tree.map(lambda a: a * (step + 1), grads)
        (jqs, jss), jstate = jopt.compress_with_feedback(g, jstate)
        (pqs, pss), pstate = optim.compress_with_feedback(
            jax.tree.map(torch.from_numpy, g), pstate)
        for key in ("w",):
            np.testing.assert_array_equal(pqs[key].numpy(),
                                          np.asarray(jqs[key]))
        np.testing.assert_array_equal(pqs["b"]["c"].numpy(),
                                      np.asarray(jqs["b"]["c"]))
        np.testing.assert_allclose(pstate.error["w"].numpy(),
                                   np.asarray(jstate.error["w"]), rtol=RTOL,
                                   atol=RTOL * np.abs(x).max())


# ---------------------------------------------------------------------------
# the reference's optimizer cases (tests/test_substrate.py), on the port
# ---------------------------------------------------------------------------

def test_adamw_descends_quadratic():
    opt = optim.AdamW(weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw w^2
        params, state = opt.update(grads, state, params, lr=0.05)
    assert float(params["w"].abs().max()) < 0.1
    assert int(state.step) == 200


def test_adamw_bf16_moments():
    opt = optim.AdamW(moments_dtype=torch.bfloat16)
    params = {"w": torch.ones((4, 4))}
    state = opt.init(params)
    assert state.m["w"].dtype == torch.bfloat16
    p2, s2 = opt.update({"w": torch.ones((4, 4))}, state, params, 1e-2)
    assert p2["w"].dtype == torch.float32
    assert s2.v["w"].dtype == torch.bfloat16


def test_weight_decay_skips_vectors():
    opt = optim.AdamW(weight_decay=1.0)
    params = {"w": torch.ones((2, 2)), "scale": torch.ones((2,))}
    state = opt.init(params)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _ = opt.update(zero, state, params, lr=0.1)
    assert float(p2["w"][0, 0]) < 1.0      # decayed
    assert float(p2["scale"][0]) == 1.0    # exempt


def test_clip_by_global_norm():
    tree = {"a": torch.full((10,), 10.0)}
    clipped, norm = optim.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000), rel=1e-5)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)


def test_schedule_warmup_cosine():
    sch = optim.warmup_cosine(1e-3, warmup_steps=10, total_steps=100)
    assert float(sch(0)) == 0.0
    assert float(sch(10)) == pytest.approx(1e-3)
    assert float(sch(100)) == pytest.approx(1e-4, rel=1e-3)
    assert float(sch(5)) == pytest.approx(5e-4)


def test_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
    state = optim.init_state(g)
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for _ in range(50):
        total_true += g["w"].numpy()
        (q, s), state = optim.compress_with_feedback(g, state)
        total_sent += optim.decompress(q["w"], s["w"]).numpy()
    # accumulated error stays bounded by one quantisation step
    resid = np.abs(total_true - total_sent).max()
    assert resid < float(g["w"].abs().max()) / 127 * 2
