"""The CUDA kernels against their plain PyTorch versions, and the batched
engine on the card against its CPU run. These need an NVIDIA GPU with
``nvcc``; without one they skip. Run them on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.runtime import (
    VectorConfig,
    batch_slots,
    make_workload,
    simulate_batch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 7), (5, 2049), (7, 130),
                                    (1, 100003), (128, 12500)])
def test_prefix_scan_kernel_matches_plain(cuda, rows, n):
    g = torch.Generator().manual_seed(rows * n)
    x = (torch.rand(rows, n, dtype=torch.float64, generator=g) * 11).to(cuda)
    before = ops.launch_counts()["prefix_scan"]
    got = ops.prefix_scan(x)
    assert ops.launch_counts()["prefix_scan"] == before + 1
    want = ref.prefix_scan_ref(x)
    scale = x.abs().sum(-1, keepdim=True)
    assert ((got - want).abs() <= 1e-12 * scale).all()


@pytest.mark.parametrize("r,t,e,frac", [(1, 64, 4, 1.0), (3, 533, 6, 0.7),
                                        (2, 8, 128, 1.0), (4, 5000, 1, 0.5),
                                        (4, 5000, 12500, 0.5),
                                        (3, 7000, 40000, 0.5),
                                        (3, 100, 8, 0.0)])
def test_dispatch_kernel_matches_plain(cuda, r, t, e, frac):
    g = torch.Generator().manual_seed(r * t + e)
    idx = torch.randint(0, e, (r, t), generator=g, dtype=torch.int32)
    keep = torch.rand(r, t, generator=g) < frac
    idx = torch.where(keep, idx, torch.full_like(idx, -1)).to(cuda)
    w = (torch.rand(r, t, generator=g, dtype=torch.float64) * 11).to(cuda)
    got_p, got_f = ops.dispatch_work_prefix(idx, w, e)
    want_p, want_f = ref.dispatch_work_prefix_ref(idx, w, e)
    torch.testing.assert_close(got_p, want_p, rtol=1e-12, atol=0)
    torch.testing.assert_close(got_f, want_f, rtol=1e-12, atol=0)


def test_engine_on_card_matches_cpu_and_repeats_bit_for_bit(cuda):
    powers = np.random.default_rng(0).integers(1, 11, size=64).astype(float)
    cfg = VectorConfig(n_nodes=64, n_slots=80, fifo_dispatch=True,
                       probe=True)
    wls = [make_workload("bursty", horizon=80.0, seed=s, rate_hi=60.0)
           for s in range(8)]
    slot, works, _ = batch_slots(wls, 1.0, 80)
    a = simulate_batch(slot, works, powers, cfg, device=cuda)
    b = simulate_batch(slot, works, powers, cfg, device=cuda)
    c = simulate_batch(slot, works, powers, cfg, device="cpu")
    for k in ("mean_response", "p99_response", "makespan", "trigger_fires",
              "moved_units", "completed", "probe_queue"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        np.testing.assert_allclose(getattr(a, k), getattr(c, k), rtol=1e-6,
                                   atol=1e-9)
