"""The port's distributed layer against the JAX package's on the CPU.

* ``core.scan.axis_exclusive_scan`` / ``axis_inclusive_scan`` over 8 gloo
  ranks (``_torch_ranks.run_ranks``) against the JAX ladder under
  ``shard_map`` on 8 XLA host devices in a subprocess, as
  ``tests/test_core_scan.py`` runs it: the partial sums bit for bit, the
  total within 1e-12 relative (an all-reduce adds in its own order).
* ``launch.mesh`` on a one-process ``fake`` world: the production meshes'
  shapes and names, the expert-parallel variants and their factoring
  check, ``elastic_shape`` against the JAX function, ``elastic_mesh``,
  ``mesh_axis_sizes`` (also of the audit's stand-in), ``set_mesh`` and
  ``logical_axis_rules`` bound for a ``with`` block.
* ``kernels.ops`` refuses a DTensor, and takes the plain route on meta.
* An LM built on meta (``materialize=False``) draws the weights
  ``LM.init`` draws, bit for bit, and the loop refuses a bound mesh
  without bound ``logical_axis_rules``.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import contextlib
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

import _torch_rank_fns as fns  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro.launch.mesh import elastic_shape as jax_elastic_shape  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DocStream, Pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    current_rules,
    logical_axis_rules,
)
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.train import LoopConfig, train  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOTAL_RTOL = 1e-12

JAX_LADDER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.scan import axis_exclusive_scan

vals = np.load(sys.argv[1])
mesh = jax.make_mesh((8,), ("x",))
shard_map = getattr(jax, "shard_map", None)
if shard_map is None:  # jax < 0.5
    from jax.experimental.shard_map import shard_map
exc, tot = jax.jit(shard_map(lambda x: axis_exclusive_scan(x, "x", 8),
                             mesh=mesh, in_specs=P("x"),
                             out_specs=(P("x"), P("x"))))(vals)
np.save(sys.argv[2], np.asarray(exc))
np.save(sys.argv[3], np.asarray(tot))
"""


def test_axis_scans_equal_the_jax_ladder(tmp_path):
    vals = np.random.default_rng(0).standard_normal((8, 5))
    np.save(tmp_path / "vals.npy", vals)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", JAX_LADDER, str(tmp_path / "vals.npy"),
         str(tmp_path / "exc.npy"), str(tmp_path / "tot.npy")],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jexc = np.load(tmp_path / "exc.npy")
    jtot = np.load(tmp_path / "tot.npy")
    ranks = run_ranks(fns.axis_scans, 8, tmp_path, vals, timeout=120)
    for r, got in enumerate(ranks):
        assert got["exc"].dtype == np.float64
        assert np.array_equal(got["exc"], jexc[r]), r
        assert np.array_equal(got["inc"], jexc[r] + vals[r]), r
        for key in ("total", "total2"):
            np.testing.assert_allclose(got[key], jtot[r], rtol=TOTAL_RTOL,
                                       atol=0)
        # an axis of size 1: (zeros, x), as the reference returns
        assert np.array_equal(got["one_exc"], np.zeros(5))
        assert np.array_equal(got["one_total"], vals[r])
    assert np.array_equal(ranks[0]["exc"], np.zeros(5))


@contextlib.contextmanager
def fake_world(size):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,ep,shape,names", [
    (False, None, (16, 16), ("data", "model")),
    (True, None, (2, 16, 16), ("pod", "data", "model")),
    (False, 2, (2, 8, 16), ("expert", "data", "model")),
    (False, 4, (4, 4, 16), ("expert", "data", "model")),
    (False, 8, (8, 2, 16), ("expert", "data", "model")),
    (True, 4, (2, 4, 4, 16), ("pod", "expert", "data", "model")),
])
def test_production_meshes(multi_pod, ep, shape, names):
    with fake_world(int(np.prod(shape))):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, ep=ep,
                                             device_type="cpu")
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == names
        assert mesh_mod.mesh_axis_sizes(mesh) == dict(zip(names, shape))


def test_expert_axis_must_factor_a_pod():
    with pytest.raises(ValueError, match="doesn't factor a 256-chip pod"):
        mesh_mod.make_production_mesh(ep=3, device_type="cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 15, 16, 17, 100, 255, 256])
@pytest.mark.parametrize("mp", [1, 2, 16])
def test_elastic_shape_equals_jax(n, mp):
    assert mesh_mod.elastic_shape(n, mp) == jax_elastic_shape(n, mp)


@pytest.mark.parametrize("n,mp,shape", [(8, 2, (4, 2)), (6, 2, (3, 2)),
                                        (1, 2, (1, 1))])
def test_elastic_mesh(n, mp, shape):
    """The reference's ``test_elastic_mesh_factorisation`` cases."""
    with fake_world(int(np.prod(shape))):
        mesh = mesh_mod.elastic_mesh(n, model_parallel=mp,
                                     device_type="cpu")
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == ("data", "model")


def test_mesh_axis_sizes_of_the_audit_stand_in():
    stand_in = SimpleNamespace(axis_names=("pod", "data", "model"),
                               devices=np.empty((2, 16, 16), dtype=object))
    assert mesh_mod.mesh_axis_sizes(stand_in) == {"pod": 2, "data": 16,
                                                  "model": 16}


def test_set_mesh_and_rules_bind_for_a_block():
    a, b = object(), object()
    assert mesh_mod.current_mesh() is None and current_rules() is None
    with mesh_mod.set_mesh(a) as bound:
        assert bound is a and mesh_mod.current_mesh() is a
        with mesh_mod.set_mesh(b), logical_axis_rules({"batch": ("data",)}):
            assert mesh_mod.current_mesh() is b
            assert current_rules() == {"batch": ("data",)}
        assert mesh_mod.current_mesh() is a and current_rules() is None
    assert mesh_mod.current_mesh() is None


def test_kernels_refuse_a_dtensor():
    with fake_world(4):
        mesh = mesh_mod.elastic_mesh(4, model_parallel=2, device_type="cpu")
        q = DTensor.from_local(torch.zeros(1, 2, 8, 16), mesh,
                               [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="not a DTensor"):
            ops.flash_attention(q, q, q)
        with pytest.raises(TypeError, match="not a DTensor"):
            ops.mamba_scan(q, q)
        with pytest.raises(TypeError, match="not a DTensor"):
            ops.dispatch_positions_levels(q.to(torch.int32), 4, 8)


def test_meta_tensors_take_the_plain_route_for_shapes():
    q = torch.empty(2, 4, 64, 32, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(2, 2, 64, 32, device="meta", dtype=torch.bfloat16)
    out = ops.flash_attention(q, kv, kv,
                              lengths=torch.empty(2, dtype=torch.int32,
                                                  device="meta"))
    assert out.shape == q.shape and out.dtype == q.dtype
    da = torch.empty(2, 64, 8, 16, device="meta", requires_grad=True)
    h = ops.mamba_scan(da, da)
    assert h.shape == da.shape and h.dtype == torch.float32
    assert h.requires_grad
    idx = torch.empty(3, 10, 2, device="meta", dtype=torch.int32)
    slot, keep, filled = ops.dispatch_positions_levels(idx, 4, 8)
    assert slot.shape == idx.shape and slot.dtype == torch.int32
    assert keep.dtype == torch.bool and filled.shape == (3, 4)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b",
                                  "jamba-v0.1-52b", "internvl2-1b"])
def test_an_lm_built_on_meta_draws_what_init_draws(arch):
    cfg = get_config(arch).smoke()
    whole = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    lazy = LM(cfg, device="cpu", materialize=False)
    assert all(p.is_meta for p in lazy.parameters())
    lazy.init(torch.Generator().manual_seed(3))
    got = dict(lazy.named_parameters())
    assert sorted(got) == sorted(dict(whole.named_parameters()))
    for name, p in whole.named_parameters():
        assert got[name].device.type == "cpu", name
        assert got[name].dtype == p.dtype and torch.equal(got[name], p), name


def test_the_loop_needs_rules_bound_with_a_mesh():
    cfg = get_config("olmo-1b").smoke()
    pipe = Pipeline(DocStream(vocab_size=cfg.vocab_size, mean_len=8,
                              max_len=16, seed=0), shard_dims=(1,),
                    rows_per_shard=2, seq_len=16)
    lm = LM(cfg, device="cpu", materialize=False)
    with mesh_mod.set_mesh(object()):
        with pytest.raises(ValueError, match="logical_axis_rules"):
            train(lm, AdamW(), constant(1e-3), pipe, LoopConfig(steps=1))
