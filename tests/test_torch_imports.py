"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor the JAX package, and builds no kernel."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
from repro_torch.kernels import _build
print(json.dumps({
    "modules": names,
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "repro")),
    "msgpack": "msgpack" in sys.modules,
    "fake_pg": "torch.testing._internal.distributed.fake_pg" in sys.modules,
    "built": _build.BUILD_DIR.exists() and any(_build.BUILD_DIR.iterdir()),
    "libs": len(_build._LIBS),
}))
"""


@pytest.fixture(scope="module")
def report():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax_or_repro(report):
    assert report["foreign"] == []
    assert report["libs"] == 0
    for mod in ("repro_torch.lab.backends", "repro_torch.kernels.ops",
                "repro_torch.runtime.vector_backend", "repro_torch.core.pslb",
                "repro_torch.kernels.psts_dispatch"):
        assert mod in report["modules"]


def test_serving_subpackages_import_without_jax_or_repro(report):
    """The serving slice's subpackages, module by module."""
    assert report["foreign"] == []
    assert report["libs"] == 0
    for sub, mods in {
            "configs": ("base", "granite_moe_1b", "olmo_1b"),
            "models": ("common", "mlp", "attention", "moe", "ssm", "model",
                       "convert"),
            "sched": ("moe_dispatch", "request_sched"),
            "serve": ("engine",),
            "launch": ("serve",),
            "kernels": ("flash_attention", "mamba_scan"),
            "core": ("psts",)}.items():
        assert f"repro_torch.{sub}" in report["modules"]
        for mod in mods:
            assert f"repro_torch.{sub}.{mod}" in report["modules"]


def test_event_engine_modules_import_without_jax_or_repro(report):
    """The event engine's modules: the telemetry subsystem, the engine and
    its event queue, and the paper simulator."""
    assert report["foreign"] == []
    assert report["libs"] == 0
    for sub, mods in {
            "obs": ("tracer", "registry", "probe", "monitor", "anomaly",
                    "export", "wire"),
            "runtime": ("events", "runtime"),
            "core": ("simulator",)}.items():
        assert f"repro_torch.{sub}" in report["modules"]
        for mod in mods:
            assert f"repro_torch.{sub}.{mod}" in report["modules"]


def test_trace_graph_federation_modules_import_without_jax_or_repro(report):
    """The trace parsers, the DAG generators and the federation layer."""
    assert report["foreign"] == []
    assert report["libs"] == 0
    for sub, mods in {
            "graphs": ("dag",),
            "traces": ("io", "schema", "normalized", "google", "azure",
                       "machines", "synth"),
            "federation": ("specs", "balancer", "runtime", "backend")
    }.items():
        assert f"repro_torch.{sub}" in report["modules"]
        for mod in mods:
            assert f"repro_torch.{sub}.{mod}" in report["modules"]


def test_training_modules_import_without_jax_repro_or_msgpack(report):
    """The training slice: optimizer, train step and loop, checkpoints and
    the training CLI. The checkpoint manifest is JSON: msgpack, which the
    JAX package's checkpoints use, is not on the card's machine."""
    assert report["foreign"] == []
    assert report["msgpack"] is False
    assert report["libs"] == 0
    for sub, mods in {
            "optim": ("adamw", "compress", "schedule"),
            "train": ("state", "step", "loop"),
            "checkpoint": ("ckpt",),
            "launch": ("train",)}.items():
        assert f"repro_torch.{sub}" in report["modules"]
        for mod in mods:
            assert f"repro_torch.{sub}.{mod}" in report["modules"]


def test_distributed_modules_import_without_jax_repro_or_the_fake_backend(
        report):
    """The distributed slice: meshes, sharding plans, the sharded step's
    pieces, the dry run, the roofline and its summary. Importing them
    starts no process group; the dry run imports the ``fake`` backend only
    when it runs a cell."""
    assert report["foreign"] == []
    assert report["fake_pg"] is False
    assert report["libs"] == 0
    for sub, mods in {
            "launch": ("mesh", "shardings", "dryrun", "roofline",
                       "summarize"),
            "models": ("distributed",),
            "train": ("sharded",),
            "core": ("scan",)}.items():
        assert f"repro_torch.{sub}" in report["modules"]
        for mod in mods:
            assert f"repro_torch.{sub}.{mod}" in report["modules"]
