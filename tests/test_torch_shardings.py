"""The port's sharding plans (``launch.shardings``) against the JAX
package's, for every arch in ``REGISTRY`` on the single- and multi-pod
meshes and their expert-parallel variants (ep 2, 4, 8). Pure shape logic:
the JAX side through ``jax.eval_shape``, the port's through
``LM(cfg, device="meta")``, both over the sharding audit's stand-in meshes
(``tests/test_shardspec_audit.py``: axis names and a device array).

* Every parameter and moment spec equals the JAX spec of the leaf at its
  JAX path (``models.convert.jax_key``) entry by entry, the stacked stage
  entry dropped and padded with None to the leaf's rank.
* Every cache spec (the port's caches keep the stacked JAX layout) and
  batch spec equals the JAX one, for every serving shape the audit takes.
* ``activation_rules`` equals the JAX rules, with and without a shape.
* The audit passes on the port's specs: each divides its dimension.
* ``placements`` turns a spec into the DTensor placements.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import functools
from types import SimpleNamespace

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models.common import dtype_of as jax_dtype  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro_torch.configs import REGISTRY, SHAPES  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.common import param_tree  # noqa: E402
from repro_torch.models.convert import jax_key  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402


def stand_in(names, shape):
    return SimpleNamespace(axis_names=names,
                           devices=np.empty(shape, dtype=object))


def ep_mesh(ep, multi):
    data = 256 // (ep * 16)
    if multi:
        return stand_in(("pod", "expert", "data", "model"),
                        (2, ep, data, 16))
    return stand_in(("expert", "data", "model"), (ep, data, 16))


MESHES = {"single": stand_in(("data", "model"), (16, 16)),
          "multi": stand_in(("pod", "data", "model"), (2, 16, 16))}
for _ep in (2, 4, 8):
    MESHES[f"ep{_ep}"] = ep_mesh(_ep, False)
    MESHES[f"multi-ep{_ep}"] = ep_mesh(_ep, True)
ARCHS = sorted(REGISTRY)
SERVE_SHAPES = [name for name, s in SHAPES.items() if s.kind != "train"]


def sizes(mesh):
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def as_tuple(spec):
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in spec)


def jax_flat(spec_tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jsh._path_str(path): as_tuple(s) for path, s in leaves}


@functools.lru_cache(maxsize=None)
def jax_state(arch):
    cfg = JAX_REGISTRY[arch]
    lm = JaxLM(cfg)
    opt = JaxAdamW(moments_dtype=jax_dtype(cfg.moments_dtype))
    return jax.eval_shape(lambda: jax_init_state(lm, opt,
                                                 jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def port_lm(arch):
    return LM(REGISTRY[arch], device="meta")


def node(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


def audit(specs_and_shapes, mesh, what):
    """The audit of tests/test_shardspec_audit.py: every spec entry
    divides its dimension."""
    ax = sizes(mesh)
    for spec, shape in specs_and_shapes:
        assert len(spec) <= len(shape), (what, spec, shape)
        for i, part in enumerate(spec):
            axes = (part,) if isinstance(part, str) else tuple(part or ())
            div = int(np.prod([ax[a] for a in axes]))
            assert shape[i] % div == 0, (what, spec, shape)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_equal_jax(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg = REGISTRY[arch]
    jstate = jax_state(arch)
    jcfg = JAX_REGISTRY[arch]
    jspecs = jsh.state_pspecs(jstate, jcfg, mesh)
    want = {"params": jax_flat(jspecs.params), "m": jax_flat(jspecs.opt.m),
            "v": jax_flat(jspecs.opt.v)}
    assert jspecs.opt.step == P()
    lm = port_lm(arch)
    params = param_tree(lm)
    specs = sh.state_pspecs(TrainState(params, AdamWState(None, params,
                                                          params)),
                            cfg, mesh)
    assert specs.opt.step == ()
    got = {"params": specs.params, "m": specs.opt.m, "v": specs.opt.v}
    for name, p in lm.named_parameters():
        path, stacked = jax_key(name)
        for kind in ("params", "m", "v"):
            j = want[kind][path]
            j = j[1:] if stacked else j
            j = j + (None,) * (p.dim() - len(j))
            assert node(got[kind], name) == j, (kind, name)
    n_jax = sum(int(np.prod(x.shape[:1])) if k.startswith("stages/") else 1
                for k, x in jax_flat_shapes(jstate.params).items())
    assert n_jax == len(list(lm.parameters()))
    audit([(node(got[kind], name), tuple(p.shape))
           for kind in got for name, p in lm.named_parameters()],
          mesh, f"{arch} state")


def jax_flat_shapes(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jsh._path_str(path): x for path, x in leaves}


def _port_cache_items(cache, specs):
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from _port_cache_items(cache[k], specs[k])
    else:
        for t, s in zip(cache, specs):
            yield t, s


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_jax(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    jlm, lm = JaxLM(jcfg), port_lm(arch)
    for name in SERVE_SHAPES:
        shape, jshape = SHAPES[name], JAX_SHAPES[name]
        if name == "long_500k" and not cfg.subquadratic:
            continue
        jcache = jax.eval_shape(lambda: jlm.init_cache(
            jshape.global_batch, jshape.seq_len, dtype=jnp.bfloat16))
        jspecs = jsh.cache_pspecs(jcache, jcfg, mesh, jshape)
        cache = lm.init_cache(shape.global_batch, shape.seq_len)
        specs = sh.cache_pspecs(cache, cfg, mesh, shape)
        want = [as_tuple(s) for s in jax.tree.leaves(
            jspecs, is_leaf=lambda x: isinstance(x, P))]
        items = list(_port_cache_items(cache, specs))
        assert [s for _, s in items] == want, name
        assert [tuple(t.shape) for t, _ in items] == [
            tuple(x.shape) for x in jax.tree.leaves(jcache)]
        audit([(s, tuple(t.shape)) for t, s in items], mesh,
              f"{arch}/{name} cache")
        jb = jsh.batch_pspecs(jcfg, mesh, jshape)
        assert sh.batch_pspecs(cfg, mesh, shape) == {
            k: as_tuple(v) for k, v in jb.items()}
    for name in SHAPES:
        assert sh.batch_pspecs(cfg, mesh, SHAPES[name]) == {
            k: as_tuple(v) for k, v in jsh.batch_pspecs(
                jcfg, mesh, JAX_SHAPES[name]).items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_rules_and_moe_layout_equal_jax(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    assert sh.moe_layout(cfg, sizes(mesh)) == jsh.moe_layout(jcfg,
                                                             sizes(mesh))
    assert sh.activation_rules(cfg, mesh) == jsh.activation_rules(jcfg,
                                                                  mesh)
    for name in SHAPES:
        assert sh.activation_rules(cfg, mesh, SHAPES[name]) == \
            jsh.activation_rules(jcfg, mesh, JAX_SHAPES[name])


def test_placements():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements(mesh, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.placements(mesh, (None, "model", None)) == (
        Replicate(), Replicate(), Shard(1))
    assert sh.placements(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="shards two tensor dims"):
        sh.placements(mesh, ("data", "data"))


def test_jax_key_inverts_the_conversion():
    from repro_torch.models.convert import from_jax_params
    cfg = REGISTRY["jamba-v0.1-52b"].smoke()
    jparams = jax.eval_shape(JaxLM(JAX_REGISTRY["jamba-v0.1-52b"].smoke())
                             .init, jax.random.key(0))
    flat = jax_flat_shapes(jparams)
    state = from_jax_params(cfg, jax.tree.map(
        lambda x: np.zeros(x.shape, np.float32), jparams))
    for name, t in state.items():
        path, stacked = jax_key(name)
        assert path in flat
        assert tuple(flat[path].shape) == ((cfg.n_layers // cfg.attn_every,)
                                           + tuple(t.shape) if stacked
                                           else tuple(t.shape))
