"""The port's kernels on the CPU: each plain PyTorch version held against the
JAX package's Pallas kernel in interpret mode (as tests/test_kernels.py runs
it), in float64, plus the dispatch edges the Pallas kernel cannot take
(E > 128). The CUDA kernels themselves run only on the card: see
tests/test_torch_cuda.py and chip_smoke.py."""

from types import SimpleNamespace

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.prefix_scan import prefix_scan_pallas  # noqa: E402
from repro.kernels.psts_dispatch import dispatch_work_prefix_pallas  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.prefix_scan import prefix_scan_cuda  # noqa: E402
from repro_torch.kernels.psts_dispatch import (  # noqa: E402
    dispatch_work_prefix_cuda,
)

RTOL = 1e-12  # float64, different summation association than Pallas


def _loop_oracle(e_idx, w, e):
    """The scalar FIFO loop of simulate_scalar, per row."""
    r, t = e_idx.shape
    pos = np.zeros((r, t))
    fill = np.zeros((r, e))
    for i in range(r):
        acc = np.zeros(e)
        for j in range(t):
            d = e_idx[i, j]
            if 0 <= d < e:
                pos[i, j] = acc[d]
                acc[d] += w[i, j]
        fill[i] = acc
    return pos, fill


# ---------------------------------------------------------------------------
# prefix scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,n,bc", [(1, 64, 64), (4, 1000, 256),
                                       (7, 130, 32), (16, 4096, 512)])
def test_prefix_scan_ref_matches_pallas_f64(rows, n, bc):
    x = np.random.default_rng(0).normal(size=(rows, n))
    with jax.enable_x64():
        want = np.asarray(prefix_scan_pallas(jnp.asarray(x), block_cols=bc))
    got = ops.prefix_scan(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float64
    # relative to the row's magnitude: a prefix may sum to ~0
    scale = np.abs(x).sum(axis=1, keepdims=True)
    assert (np.abs(got - want) <= RTOL * scale).all()


@pytest.mark.parametrize("np_dtype,torch_dtype,jnp_dtype",
                         [(np.float32, torch.float32, jnp.float32),
                          (np.int32, torch.int32, jnp.int32)])
def test_prefix_scan_ref_dtypes_match_pallas(np_dtype, torch_dtype,
                                             jnp_dtype):
    x = np.random.default_rng(1).integers(0, 9, size=(3, 257)).astype(np_dtype)
    want = np.asarray(prefix_scan_pallas(jnp.asarray(x, jnp_dtype),
                                         block_cols=64))
    got = ops.prefix_scan(torch.from_numpy(x))
    assert got.dtype == torch_dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefix_scan_ref_matches_jnp_oracle_on_main_path_shape():
    """(B, M) task works as the batched engine scans them."""
    x = np.random.default_rng(2).uniform(1.0, 11.0, size=(8, 3001))
    with jax.enable_x64():
        want = np.asarray(jref.prefix_scan_ref(jnp.asarray(x)))
    np.testing.assert_allclose(ops.prefix_scan(torch.from_numpy(x)).numpy(),
                               want, rtol=RTOL)


# ---------------------------------------------------------------------------
# dispatch work prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,t,e,bt", [(1, 64, 4, 32), (3, 533, 6, 128),
                                      (5, 100, 32, 64), (2, 8, 128, 8)])
def test_dispatch_work_prefix_ref_matches_pallas_f64(r, t, e, bt):
    rng = np.random.default_rng(r * t + e)
    e_idx = rng.integers(-1, e, size=(r, t)).astype(np.int32)
    w = rng.exponential(2.0, size=(r, t))
    w[e_idx < 0] = 0.0
    with jax.enable_x64():
        pos, fill = dispatch_work_prefix_pallas(
            jnp.asarray(e_idx), jnp.asarray(w), n_experts=e, block_tokens=bt)
        pos, fill = np.asarray(pos), np.asarray(fill)
    got_pos, got_fill = ops.dispatch_work_prefix(
        torch.from_numpy(e_idx), torch.from_numpy(w), e)
    np.testing.assert_allclose(got_pos.numpy(), pos, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got_fill.numpy(), fill, rtol=RTOL, atol=0)


@pytest.mark.parametrize("r,t,e", [(3, 2000, 129), (2, 5000, 12500),
                                   (4, 3000, 1), (1, 1, 7)])
def test_dispatch_work_prefix_ref_any_width_matches_loop(r, t, e):
    """The port lifts the Pallas kernel's E <= 128 lane limit: at full
    width E is the cluster's node count."""
    rng = np.random.default_rng(e + t)
    e_idx = rng.integers(-1, e, size=(r, t)).astype(np.int32)
    w = rng.uniform(1.0, 11.0, size=(r, t))
    pos, fill = _loop_oracle(e_idx, w, e)
    got_pos, got_fill = ops.dispatch_work_prefix(
        torch.from_numpy(e_idx), torch.from_numpy(w), e)
    np.testing.assert_allclose(got_pos.numpy(), pos, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got_fill.numpy(), fill, rtol=RTOL, atol=0)


def _ordered_loop_from(e_idx, w, e, init):
    """simulate_scalar's loop with each destination's sum started at
    ``init`` (np.add.at's order when the sums are the queues), in Python
    floats (IEEE float64)."""
    r, t = e_idx.shape
    pos = np.zeros((r, t))
    fill = np.zeros((r, e))
    for i in range(r):
        acc = init[i].tolist()
        out = pos[i].tolist()
        for j, (d, x) in enumerate(zip(e_idx[i].tolist(), w[i].tolist())):
            if 0 <= d < e:
                out[j] = acc[d]
                acc[d] += x
        pos[i] = out
        fill[i] = acc
    return pos, fill


@pytest.mark.parametrize("r,t,e,runs", [(3, 2000, 129, False),
                                        (2, 5000, 12500, False),
                                        (4, 3000, 1, False),
                                        (2, 4000, 16, True), (1, 1, 7, False)])
@pytest.mark.parametrize("with_init", [False, True])
def test_dispatch_work_prefix_ref_is_the_ordered_loop(r, t, e, runs,
                                                      with_init):
    """Bit for bit (not within a tolerance) the loop the engine's branches
    are held to: each destination's sum left to right, from 0 or from
    ``init``; ``runs`` sorts the destinations into long runs, as the
    per-slot totals call has them."""
    rng = np.random.default_rng(e + t + with_init)
    e_idx = rng.integers(-1, e, size=(r, t))
    if runs:
        e_idx = np.sort(e_idx, axis=1)
    e_idx = e_idx.astype(np.int32)
    w = rng.uniform(0.1, 11.0, size=(r, t))
    init = (rng.uniform(0.0, 500.0, size=(r, e)) if with_init
            else np.zeros((r, e)))
    pos, fill = _ordered_loop_from(e_idx, w, e, init)
    got_pos, got_fill = ops.dispatch_work_prefix(
        torch.from_numpy(e_idx), torch.from_numpy(w), e,
        init=torch.from_numpy(init) if with_init else None)
    np.testing.assert_array_equal(got_pos.numpy(), pos)
    np.testing.assert_array_equal(got_fill.numpy(), fill)


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 7), (2, 2049), (4, 12500)])
def test_prefix_scan_ref_is_numpys_cumsum(rows, n):
    """The plain scan is np.cumsum(x) - x bit for bit: the oracle's
    ``S`` and ``lam``."""
    x = np.random.default_rng(n).uniform(0.0, 11.0, size=(rows, n))
    got = ops.prefix_scan(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.cumsum(x, axis=-1) - x)


def test_dispatch_work_prefix_ref_edges():
    # all tokens without a destination, out-of-range ones, and no tokens
    idx = torch.tensor([[-1, -1, -1], [5, 2, -7]], dtype=torch.int32)
    w = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], dtype=torch.float64)
    pos, fill = ops.dispatch_work_prefix(idx, w, 3)
    assert pos.tolist() == [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]
    assert fill.tolist() == [[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]]
    pos, fill = ops.dispatch_work_prefix(
        torch.zeros((2, 0), dtype=torch.int32),
        torch.zeros((2, 0), dtype=torch.float64), 4)
    assert pos.shape == (2, 0) and fill.shape == (2, 4)
    assert not fill.any()


def test_dispatch_unit_weights_are_the_positional_scan():
    """With unit weights the weighted prefix IS the per-expert position of
    the JAX oracle ``dispatch_positions_ref``."""
    e_idx = np.random.default_rng(9).integers(0, 5, size=200).astype(np.int32)
    pos_i, fill_i = jref.dispatch_positions_ref(
        jnp.asarray(e_idx), jnp.zeros(5, jnp.int32), 5)
    pos_w, fill_w = ops.dispatch_work_prefix(
        torch.from_numpy(e_idx[None, :]), torch.ones((1, 200),
                                                     dtype=torch.float64), 5)
    np.testing.assert_array_equal(pos_w[0].numpy(), np.asarray(pos_i))
    np.testing.assert_array_equal(fill_w[0].numpy(), np.asarray(fill_i))


# ---------------------------------------------------------------------------
# device routing, launch counters, build
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = ops.launch_counts()
    ops.prefix_scan(torch.ones(2, 5, dtype=torch.float64))
    ops.dispatch_work_prefix(torch.zeros((1, 3), dtype=torch.int32),
                             torch.ones((1, 3), dtype=torch.float64), 2)
    assert ops.launch_counts() == before


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="CUDA tensor"):
        prefix_scan_cuda(torch.ones(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA device"):
        dispatch_work_prefix_cuda(torch.zeros((1, 3), dtype=torch.int32),
                                  torch.ones((1, 3), dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.prefix_scan(SimpleNamespace(device=torch.device("xla")))
    # meta tensors (the dry run) take the plain version, for shapes alone
    assert ops.prefix_scan(torch.ones(2, 3, device="meta")).shape == (2, 3)


def test_build_names_a_digest_library_in_the_ignored_build_dir(monkeypatch,
                                                                tmp_path):
    path = _build._library_path("prefix_scan")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert path.name.startswith("prefix_scan-") and path.suffix == ".so"
    # no toolkit: a clear error, not a silent fallback
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
