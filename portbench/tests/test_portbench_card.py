"""On the card: a whole short run of each cell through the command line.
Run on a machine with a CUDA device::

    python -m pytest -q -m cuda portbench/tests
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.manifest import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", ["clusterdata-12.5k.poisson",
                                  "alibaba-4k.bursty"])
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         cell, "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
