"""The import guard compares top-level module names whole."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.manifest import BENCH_DIR, ROOT
from portbench.run import FORBIDDEN, forbidden_modules


def test_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.runtime", "reprox", "jaxtyping",
              "flaxen", "numpy", "repro", "repro.core.scan", "jax.numpy",
              "jaxlib.xla_client", "flax.linen"]
    assert forbidden_modules(loaded) == sorted(
        ["repro", "repro.core.scan", "jax.numpy", "jaxlib.xla_client",
         "flax.linen"])
    assert forbidden_modules(["repro_torch.lab", "numpy"]) == []
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_run_path_loads_no_jax():
    """Importing the harness and the engine it drives loads nothing the
    guard refuses (in a fresh process: this one has the test suite's)."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import portbench.run as r, portbench.gen, portbench.devtrace\n"
            "from portbench.manifest import load_module\n"
            "load_module('runners', 'sweep')\n"
            "load_module('references', 'psts_sweep')\n"
            "import repro_torch.runtime.vector_backend\n"
            "print(r.forbidden_modules())\n") % (str(ROOT / "src"),
                                                 str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    source = (ROOT / "portbench" / "references" / "psts_sweep.py").read_text()
    assert "repro" not in source.replace("simulate_scalar", "")\
        .split('"""', 2)[2]
    assert "import torch" not in source


def test_refuses_without_a_card():
    """No result and a nonzero exit where torch sees no CUDA device."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "alibaba-4k.bursty", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("imports_repro", [True, False])
def test_a_reader_that_loads_repro_gets_no_result(imports_repro, tiny_bench,
                                                  tmp_path):
    """A per-layer reader that imports a module named ``repro`` runs after
    the window; the guard still sees it, and the run prints no result."""
    manifest, bench_dir = tiny_bench
    fake = tmp_path / "fake"
    (fake / "repro").mkdir(parents=True)
    (fake / "repro" / "__init__.py").write_text("")
    metrics = tmp_path / "metrics_with_repro"
    metrics.mkdir()
    for entry in manifest["per_layer"]:
        (metrics / f"{entry['name']}.py").symlink_to(
            BENCH_DIR / "metrics" / f"{entry['name']}.py")
    (metrics / "device_idle_pct.py").unlink()
    (metrics / "device_idle_pct.py").write_text(
        ("import repro\n" if imports_repro else "")
        + "def read(trace):\n    return 1.0\n")
    (bench_dir / "metrics").unlink()
    (bench_dir / "metrics").symlink_to(metrics)
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "from pathlib import Path\n"
        "from portbench.devtrace import DeviceTrace\n"
        "from portbench.manifest import load_cell, load_manifest\n"
        "from portbench.outcome import Outcome\n"
        "from portbench.run import emit\n"
        "bench = Path(%r)\n"
        "cell = load_cell('alibaba-4k.bursty', load_manifest(), bench)\n"
        "trace = DeviceTrace(kernels=[('k', 0.0, 1.0)], copies=[],\n"
        "                    window_s=2e-6, sweeps=1, slots=1, tasks=1)\n"
        "outcome = Outcome(correct=True, attempted=2, failed=0, values={},\n"
        "                  checks={'max_rel_gap': (0.0, 1e-8)},\n"
        "                  device={'platform': 'gpu', 'kind': 'k',\n"
        "                          'count': 1, 'memory_peak_bytes': 1},\n"
        "                  trace=trace)\n"
        "sys.exit(emit(cell, outcome, True, bench))\n") % (
            str(fake), str(ROOT / "src"), str(ROOT), str(bench_dir))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    if imports_repro:
        assert out.returncode == 3 and out.stdout == ""
        assert "['repro']" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["metrics"]["device_idle_pct"]["value"] == 1.0
