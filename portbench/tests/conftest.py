"""Fixtures of the benchmark's CPU tests: a bench directory of tiny cells
(the real configurations and traffic mixes cut to a few nodes, slots and
seeds) beside the real runners, references and metric readers."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.manifest import BENCH_DIR, load_manifest

# the size a test run can hold: the cells' shapes, cut down
TINY_CONFIG = {"n_nodes": 64, "n_slots": 24}
TINY_TRAFFIC = {"seeds_per_sweep": 4}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny_bench(tmp_path):
    """``(manifest, bench_dir)`` of the real cells at tiny sizes."""
    manifest = load_manifest()
    for kind in ("runners", "references", "metrics"):
        (tmp_path / kind).symlink_to(BENCH_DIR / kind)
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    for entry in manifest["configs"]:
        config = json.loads((BENCH_DIR / "configs"
                             / f"{entry['name']}.json").read_text())
        config.update(TINY_CONFIG)
        (tmp_path / "configs" / f"{entry['name']}.json").write_text(
            json.dumps(config))
    for entry in manifest["workloads"]:
        traffic = json.loads((BENCH_DIR / "traffic"
                              / f"{entry['name']}.json").read_text())
        traffic.update(TINY_TRAFFIC)
        (tmp_path / "traffic" / f"{entry['name']}.json").write_text(
            json.dumps(traffic))
    return manifest, tmp_path
