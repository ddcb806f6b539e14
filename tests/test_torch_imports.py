"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor the JAX package, and builds no kernel."""

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
