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


@pytest.mark.parametrize("r,t,e,frac,base_hi", [
    (8, 2048, 32, 1.0, 0), (8, 1, 32, 1.0, 0), (3, 777, 1, 0.8, 5),
    (4, 3000, 128, 0.9, 3), (2, 5000, 300, 0.7, 9), (3, 100, 8, 0.0, 4),
    (1, 40000, 100000, 0.5, 2)])
def test_dispatch_positions_kernel_matches_plain(cuda, r, t, e, frac,
                                                 base_hi):
    g = torch.Generator().manual_seed(r * t + e)
    idx = torch.randint(0, e, (r, t), generator=g, dtype=torch.int32)
    keep = torch.rand(r, t, generator=g) < frac
    idx = torch.where(keep, idx, torch.full_like(idx, -1)).to(cuda)
    base = torch.randint(0, base_hi + 1, (r, e), generator=g,
                         dtype=torch.int32).to(cuda)
    before = ops.launch_counts()["dispatch_positions"]
    got_p, got_f = ops.dispatch_positions(idx, base, e)
    assert ops.launch_counts()["dispatch_positions"] == before + 1
    if e <= 4096:
        want_p, want_f = ref.dispatch_positions_ref(idx, base, e)
    else:  # the one-hot would be (r, t, e): count on the CPU instead
        want_p, want_f = _positions_loop(idx.cpu(), base.cpu(), e)
    assert torch.equal(got_p.cpu(), want_p.cpu())
    assert torch.equal(got_f.cpu(), want_f.cpu())


def _positions_loop(idx, base, e):
    pos = torch.zeros_like(idx)
    fill = base.clone()
    for i in range(idx.shape[0]):
        for j, x in enumerate(idx[i].tolist()):
            if 0 <= x < e:
                pos[i, j] = fill[i, x]
                fill[i, x] += 1
    return pos, fill


@pytest.mark.parametrize("b,h,kv,s,hd,dtype,window,softcap", [
    (2, 16, 8, 2048, 64, torch.bfloat16, None, None),
    (1, 4, 4, 1, 64, torch.bfloat16, None, None),
    (2, 4, 2, 130, 64, torch.float32, None, None),
    (1, 2, 2, 300, 128, torch.bfloat16, None, None),
    (1, 2, 1, 200, 256, torch.float32, None, None),
    (1, 16, 1, 257, 32, torch.bfloat16, 48, None),
    (1, 4, 4, 190, 64, torch.float32, None, 30.0),
    (1, 4, 4, 4096, 64, torch.bfloat16, 1000, 50.0)])
def test_flash_kernel_matches_plain(cuda, b, h, kv, s, hd, dtype, window,
                                    softcap):
    g = torch.Generator().manual_seed(b * s + hd)
    q = torch.randn(b, h, s, hd, generator=g).to(cuda, dtype)
    k = torch.randn(b, kv, s, hd, generator=g).to(cuda, dtype)
    v = torch.randn(b, kv, s, hd, generator=g).to(cuda, dtype)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_position_form_matches_plain(cuda):
    """Right-padded prompts as prefill passes them: kv_pos = -1 on padding,
    q_pos = max(pos, 0); the model's (B, S, H, hd) views go in unpermuted."""
    b, s, h, kv, hd = 4, 300, 8, 4, 64
    g = torch.Generator().manual_seed(7)
    q = torch.randn(b, s, h, hd, generator=g).to(cuda)
    k = torch.randn(b, s, kv, hd, generator=g).to(cuda)
    v = torch.randn(b, s, kv, hd, generator=g).to(cuda)
    lengths = torch.tensor([300, 1, 77, 129], device=cuda)
    pos = torch.arange(s, device=cuda).expand(b, s)
    kv_pos = torch.where(pos < lengths[:, None], pos, -1).to(torch.int32)
    q_pos = kv_pos.clamp_min(0)
    for window in (None, 40):
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        got = ops.flash_attention(*args, window=window, q_positions=q_pos,
                                  kv_positions=kv_pos)
        want = ref.flash_attention_ref(*args, window=window,
                                       q_positions=q_pos,
                                       kv_positions=kv_pos)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
