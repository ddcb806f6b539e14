"""What the dry-run tests hold of a port record (``launch.dryrun``)
against the JAX package's shape logic, on the single-pod mesh."""

from __future__ import annotations

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import roofline as jroof
from repro.launch import shardings as jsh
from repro.models import LM as JaxLM
from repro.models.common import dtype_of as jax_dtype
from repro.optim import AdamW as JaxAdamW
from repro.train import init_state as jax_init_state
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.launch import roofline

SINGLE = SimpleNamespace(axis_names=("data", "model"),
                         devices=np.empty((16, 16), dtype=object))
AXES = {"data": 16, "model": 16}
RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "n_stages",
               "lower_s", "compile_s", "memory", "cost", "collectives",
               "corrected", "roofline"}
MEMORY_KEYS = {"args_bytes", "output_bytes", "temp_bytes", "alias_bytes"}


def shard_bytes(leaves_and_specs) -> int:
    """Each leaf's bytes with every dim divided by the product of its
    spec's axis sizes."""
    total = 0
    for leaf, spec in leaves_and_specs:
        shape = list(leaf.shape)
        for i, part in enumerate(spec):
            axes = (part,) if isinstance(part, str) else tuple(part or ())
            shape[i] //= math.prod(AXES[a] for a in axes)
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total


def _pairs(shapes, specs):
    from jax.sharding import PartitionSpec as P
    return list(zip(jax.tree.leaves(shapes),
                    jax.tree.leaves(specs,
                                    is_leaf=lambda x: isinstance(x, P))))


def jax_state_bytes(arch: str, shape_name: str) -> tuple[int, int]:
    """(state bytes, input bytes) a device holds in the JAX package's plan
    of the cell."""
    cfg, shape = JAX_REGISTRY[arch], JAX_SHAPES[shape_name]
    lm = JaxLM(cfg)
    b = shape.global_batch // 16
    if shape.kind == "train":
        opt = JaxAdamW(moments_dtype=jax_dtype(cfg.moments_dtype))
        st = jax.eval_shape(lambda: jax_init_state(lm, opt,
                                                   jax.random.key(0)))
        specs = jsh.state_pspecs(st, cfg, SINGLE)
        state = shard_bytes(_pairs(st, specs))
        return state, 2 * b * shape.seq_len * 4
    params = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(
            x.shape, jnp.bfloat16 if x.dtype == jnp.float32 else x.dtype),
        jax.eval_shape(lm.init, jax.random.key(0)))
    cache = jax.eval_shape(lambda: lm.init_cache(shape.global_batch,
                                                 shape.seq_len))
    state = (shard_bytes(_pairs(params, jsh.param_pspecs(params, cfg,
                                                         SINGLE)))
             + shard_bytes(_pairs(cache, jsh.cache_pspecs(cache, cfg,
                                                          SINGLE, shape))))
    tokens = shape.seq_len if shape.kind == "prefill" else 1
    return state, b * tokens * 4 + b * 4


def check_record(rec: dict) -> None:
    arch, shape_name = rec["arch"], rec["shape"]
    cfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    shape, jshape = SHAPES[shape_name], JAX_SHAPES[shape_name]
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert MEMORY_KEYS <= set(rec["memory"])
    assert set(rec["cost"]) == {"flops", "bytes_accessed"}
    assert {"total_bytes", "total_count", "by_kind"} <= set(
        rec["collectives"])
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    # the JAX formulas over the same record give the same keys
    assert set(rec["roofline"]) == set(jroof.roofline_report(rec, jcfg,
                                                             jshape))
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert roofline.model_flops(cfg, shape) == jroof.model_flops(jcfg,
                                                                 jshape)
    assert rec["roofline"]["model_flops"] == jroof.model_flops(jcfg, jshape)
    state, inputs = jax_state_bytes(arch, shape_name)
    assert rec["memory"]["state_bytes"] == state
    assert rec["memory"]["args_bytes"] == state + inputs
    r = rec["roofline"]
    assert math.isfinite(r["roofline_fraction"]) and r[
        "roofline_fraction"] > 0
    assert math.isfinite(r["useful_compute_ratio"])
    assert 0 < r["useful_compute_ratio"] <= 1.05
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["collectives"]["total_count"] > 0
