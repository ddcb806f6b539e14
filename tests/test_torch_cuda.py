"""The CUDA kernels against their plain PyTorch versions (flash attention:
its tensor-core bfloat16 kernel and its float32 one), and the batched
engine on the card against its CPU run. These need an NVIDIA GPU with
``nvcc``; without one they skip. Run them on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
from repro_torch.runtime import (
    VectorConfig,
    batch_slots,
    make_workload,
    simulate_batch,
)

pytestmark = pytest.mark.cuda

# bfloat16 flash: each output row (over hd) within 1e-2 of the plain
# version's in relative L2 norm (bf16 rounding of P and of the output gives
# ~3e-3; a dropped or leaked key tile 0.1 or more), and every element within
# the JAX package's 3e-2 (rtol and atol)
BF16_ROW_TOL = 1e-2
BF16_TOL = 3e-2


def _row_rel_err(got, want):
    """max over output rows of ||got - want|| / ||want||, over hd."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30)).max().item()


def _assert_bf16_close(got, want):
    assert _row_rel_err(got, want) <= BF16_ROW_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


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


def _ordered_loop(idx, w, e):
    """The FIFO prefix as simulate_scalar sums it: per row, acc[d] += w in
    token order, in Python floats (IEEE float64)."""
    prefix = np.zeros(idx.shape)
    fill = np.zeros((idx.shape[0], e))
    for i in range(idx.shape[0]):
        acc = [0.0] * e
        out = prefix[i].tolist()
        for j, (d, x) in enumerate(zip(idx[i].tolist(), w[i].tolist())):
            if 0 <= d < e:
                out[j] = acc[d]
                acc[d] += x
        prefix[i] = out
        fill[i] = acc
    return torch.from_numpy(prefix), torch.from_numpy(fill)


@pytest.mark.parametrize("case", [
    "sparse wave", "dense row", "dense slot runs", "E=1", "E=40000",
    "T off the chunk", "all -1"])
def test_dispatch_kernel_is_the_ordered_loop(cuda, case):
    """prefix and fill bit for bit (torch.equal) the ordered loop: a sparse
    wave (~1/200 tokens valid, E = 12,500), a dense row (every token valid,
    E = 200, random and in runs of consecutive tokens as the engine's
    per-slot totals call has them), E = 1, E = 40,000, T not a multiple of
    the kernel's 16,384-token chunk (nor of 4), and no valid token."""
    rng = np.random.default_rng(sum(map(ord, case)))
    r, t, e = {"sparse wave": (3, 200_000, 12_500),
               "dense row": (2, 100_000, 200),
               "dense slot runs": (2, 100_000, 200),
               "E=1": (3, 40_000, 1), "E=40000": (3, 40_000, 40_000),
               "T off the chunk": (3, 2 * 16_384 + 5, 300),
               "all -1": (2, 20_000, 8)}[case]
    idx = rng.integers(0, e, size=(r, t))
    if case == "sparse wave":
        idx[rng.random((r, t)) >= 1 / 200] = -1
    elif case == "dense slot runs":
        idx = np.sort(idx, axis=1)
    elif case == "all -1":
        idx[:] = -1
    elif case not in ("dense row",):
        idx[rng.random((r, t)) < 0.3] = -1
    idx = idx.astype(np.int32)
    w = rng.random((r, t)) * 11
    before = ops.launch_counts()["dispatch_work_prefix"]
    got_p, got_f = ops.dispatch_work_prefix(
        torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda), e)
    assert ops.launch_counts()["dispatch_work_prefix"] == before + 1
    want_p, want_f = _ordered_loop(idx, w, e)
    assert torch.equal(got_p.cpu(), want_p)
    assert torch.equal(got_f.cpu(), want_f)


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 7), (5, 2049), (7, 130),
                                    (16, 12500), (2, 1_000_003)])
def test_prefix_scan_kernel_is_the_sequential_scan(cuda, rows, n):
    """Bit for bit the plain version on the CPU, np.cumsum(x) - x: the
    engine's owner choice reads these bits."""
    g = torch.Generator().manual_seed(rows + n)
    x = torch.rand(rows, n, dtype=torch.float64, generator=g) * 11
    assert torch.equal(ops.prefix_scan(x.to(cuda)).cpu(),
                       ref.prefix_scan_ref(x))


@pytest.mark.parametrize("r,t,e", [(3, 2000, 129), (2, 200_000, 12_500),
                                   (2, 40_000, 200), (3, 33_000, 1)])
def test_dispatch_kernel_from_init_is_the_ordered_loop(cuda, r, t, e):
    """With ``init``, prefix and fill bit for bit the plain version on the
    CPU, the ordered loop started from init (np.add.at into the queues)."""
    g = torch.Generator().manual_seed(r * t + e)
    idx = torch.randint(-1, e, (r, t), generator=g, dtype=torch.int32)
    w = torch.rand(r, t, generator=g, dtype=torch.float64) * 11
    init = torch.rand(r, e, generator=g, dtype=torch.float64) * 500
    got_p, got_f = ops.dispatch_work_prefix(idx.to(cuda), w.to(cuda), e,
                                            init=init.to(cuda))
    want_p, want_f = ref.dispatch_work_prefix_ref(idx, w, e, init)
    assert torch.equal(got_p.cpu(), want_p)
    assert torch.equal(got_f.cpu(), want_f)


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


def _levels_loop(topk, e, capacity):
    """The k priority levels on the CPU by counting, for shapes whose
    one-hot would not fit (see ref.dispatch_positions_levels_ref)."""
    r, _, k = topk.shape
    filled = torch.zeros((r, e), dtype=torch.int32)
    slots = []
    for s in range(k):
        pos, fill = _positions_loop(topk[:, :, s], filled, e)
        slots.append(pos)
        filled = torch.clamp(fill, max=capacity)
    slots = torch.stack(slots, dim=2)
    return slots, slots < capacity, filled


@pytest.mark.parametrize("r,t,k,e,capacity,frac", [
    (8, 2048, 8, 32, 640, 1.0),       # granite's prefill, its capacity
    (8, 2048, 8, 32, 100, 0.95),      # levels overflow: the clamp matters
    (8, 1, 8, 32, 1, 1.0),            # granite's decode
    (4, 3000, 2, 1, 700, 0.8), (4, 3000, 4, 300, 20, 0.7),
    (2, 5000, 1, 128, 30, 0.9),
    (2, 9000, 8, 16, 2000, 0.9),      # the row does not fit shared memory
    (2, 3000, 3, 100_000, 1, 0.5),    # large E: the ordered-claim path
    (1, 30_000, 2, 70_000, 3, 0.9),   # ... with the row outside it
    (3, 100, 4, 8, 5, 0.0)])
def test_dispatch_positions_levels_kernel_matches_plain(cuda, r, t, k, e,
                                                        capacity, frac):
    g = torch.Generator().manual_seed(r * t * k + e)
    topk = torch.randint(0, e, (r, t, k), generator=g, dtype=torch.int32)
    topk = torch.where(torch.rand(r, t, k, generator=g) < frac, topk, -1)
    before = ops.launch_counts()["dispatch_positions"]
    got = ops.dispatch_positions_levels(topk.to(cuda), e, capacity)
    assert ops.launch_counts()["dispatch_positions"] == before + 1
    want = (ref.dispatch_positions_levels_ref(topk, e, capacity)
            if e <= 4096 else _levels_loop(topk, e, capacity))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


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
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        _assert_bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_kernel_position_form_matches_plain(cuda):
    """Right-padded prompts as prefill passes them, by their lengths (the
    positions kv_pos = -1 on padding, q_pos = max(pos, 0)); the model's
    (B, S, H, hd) views go in unpermuted."""
    b, s, h, kv, hd = 4, 300, 8, 4, 64
    g = torch.Generator().manual_seed(7)
    q = torch.randn(b, s, h, hd, generator=g).to(cuda)
    k = torch.randn(b, s, kv, hd, generator=g).to(cuda)
    v = torch.randn(b, s, kv, hd, generator=g).to(cuda)
    lengths = torch.tensor([300, 1, 77, 129], device=cuda)
    q_pos, kv_pos = ref.prefill_positions(lengths, s)
    for window in (None, 40):
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        got = ops.flash_attention(*args, window=window, lengths=lengths)
        want = ref.flash_attention_ref(*args, window=window,
                                       q_positions=q_pos,
                                       kv_positions=kv_pos)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _check_tc(q, k, v, **kw):
    """One bfloat16 call: a tensor-core launch, within 1e-2 of the plain
    version in each row's relative norm and within the JAX package's bf16
    tolerance element by element."""
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    after = ops.launch_counts()
    assert after["flash_attention_tc"] == before["flash_attention_tc"] + 1
    assert after["flash_attention"] == before["flash_attention"] + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _assert_bf16_close(got, want)
    return got


@pytest.mark.parametrize("s", [1, 65, 129, 2048])
@pytest.mark.parametrize("hd,h,kv", [(32, 4, 4), (64, 16, 8), (64, 16, 1),
                                     (128, 8, 4), (256, 4, 2)])
def test_flash_tc_kernel_matches_plain(cuda, s, hd, h, kv):
    """Head widths 32-256 (HD 64, 128, 256 with zero-filled columns), GQA
    groups of 1, 2 and 16, ragged sequence ends."""
    g = torch.Generator().manual_seed(s * hd + kv)
    q = torch.randn(2, h, s, hd, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(2, kv, s, hd, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(2, kv, s, hd, generator=g).to(cuda, torch.bfloat16)
    _check_tc(q, k, v)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 48, None), (True, None, 30.0), (True, 100, 20.0),
    (False, None, None), (False, 70, None)])
def test_flash_tc_kernel_window_softcap(cuda, causal, window, softcap):
    g = torch.Generator().manual_seed(11)
    q = torch.randn(2, 8, 700, 64, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(2, 4, 700, 64, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(2, 4, 700, 64, generator=g).to(cuda, torch.bfloat16)
    _check_tc(q, k, v, causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("hd,kv", [(64, 8), (64, 1), (128, 4), (32, 2)])
@pytest.mark.parametrize("window", [None, 40])
def test_flash_tc_kernel_position_form(cuda, hd, kv, window):
    """Right-padded prompts of lengths 1, 64, 77 and S, the model's
    (B, S, H, hd) views passed unpermuted: the KV tiles past each length
    and, for wholly padded query tiles, all but tile 0 are skipped."""
    b, s, h = 4, 300, 16
    g = torch.Generator().manual_seed(hd + kv)
    q = torch.randn(b, s, h, hd, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(b, s, kv, hd, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(b, s, kv, hd, generator=g).to(cuda, torch.bfloat16)
    _check_tc(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              window=window,
              lengths=torch.tensor([1, 64, 77, s], device=cuda))


def test_flash_tc_counter_and_repeat(cuda):
    """flash_attention_tc counts each bfloat16 call and no float32 one; two
    calls on the same inputs give the same bits."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 16, 2048, 64, generator=g).to(cuda, torch.bfloat16)
    k = torch.randn(2, 8, 2048, 64, generator=g).to(cuda, torch.bfloat16)
    v = torch.randn(2, 8, 2048, 64, generator=g).to(cuda, torch.bfloat16)
    kw = dict(lengths=torch.tensor([1777, 300], device=cuda))
    ops.reset_launch_counts()
    a = ops.flash_attention(q, k, v, **kw)
    b = ops.flash_attention(q, k, v, **kw)
    ops.flash_attention(q.float(), k.float(), v.float(), **kw)
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_tc"]) == (3, 2)
    assert torch.equal(a, b)


_PLAN_CASES = dict(s=st.integers(1, 700), length=st.integers(1, 700),
                   causal=st.booleans(),
                   window=st.one_of(st.none(), st.integers(1, 300)))
_CARD_SETTINGS = dict(deadline=None, suppress_health_check=[
    HealthCheck.function_scoped_fixture])


@settings(max_examples=200, **_CARD_SETTINGS)
@given(block_q=st.sampled_from([64, 128]),
       block_k=st.sampled_from([64, 128]), **_PLAN_CASES)
def test_flash_tile_plan_is_the_kernels(cuda, s, length, causal, window,
                                        block_q, block_k):
    """The CUDA library's own tile rule (make_plan, which both kernels
    run, called on the host) lists the tiles of ``tile_plan``, which the
    CPU tests hold against the plain version's mask."""
    length = min(length, s)
    for q0 in range(0, s, block_q):
        assert flash.cuda_tile_plan(q0, block_q, block_k, s, length, causal,
                                    window) == flash.tile_plan(
            q0, block_q, block_k, s, length, causal, window)


@settings(max_examples=40, **_CARD_SETTINGS)
@given(**_PLAN_CASES)
def test_flash_kernels_follow_the_plan(cuda, s, length, causal, window):
    """Both kernels on the card, where a tile skipped wrongly or visited
    unmasked would show: float32 within 2e-5 of the plain version, bfloat16
    within its row and element bounds; index form when L = S."""
    length = min(length, s)
    g = torch.Generator().manual_seed(s * 701 + length)
    q = torch.randn(2, 4, s, 64, generator=g)
    k = torch.randn(2, 2, s, 64, generator=g)
    v = torch.randn(2, 2, s, 64, generator=g)
    kw = dict(causal=causal, window=window)
    if length < s:
        kw["lengths"] = torch.tensor([length, s], device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        args = [x.to(cuda, dtype) for x in (q, k, v)]
        got = ops.flash_attention(*args, **kw)
        want = ref.flash_attention_ref(*args, **kw)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        else:
            _assert_bf16_close(got, want)


@pytest.mark.parametrize("b,s,n,di,dtype,padded", [
    (1, 1, 16, 8192, torch.float32, False),
    (2, 130, 16, 256, torch.float32, False),
    (3, 70, 4, 36, torch.float32, True),       # di % 4 != 0: one channel
    (2, 333, 16, 256, torch.bfloat16, False),
    (2, 77, 3, 37, torch.bfloat16, True),
    (1, 2048, 16, 8192, torch.float32, True)])
def test_mamba_scan_kernel_matches_plain(cuda, b, s, n, di, dtype, padded):
    g = torch.Generator().manual_seed(b * s + di)
    da = (torch.rand(b, s, n, di, generator=g) * 0.5 + 0.5).to(cuda, dtype)
    dbx = torch.randn(b, s, n, di, generator=g).to(cuda, dtype)
    if padded:          # right padding is the identity transition
        lens = torch.randint(1, s + 1, (b,), generator=g).to(cuda)
        pad = torch.arange(s, device=cuda)[None, :] >= lens[:, None]
        da[pad] = 1.0
        dbx[pad] = 0.0
    before = ops.launch_counts()["mamba_scan"]
    got = ops.mamba_scan(da, dbx)
    assert ops.launch_counts()["mamba_scan"] == before + 1
    assert got.dtype == torch.float32 and got.shape == da.shape
    want = ref.mamba_scan_ref(da, dbx)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if padded:
        last = got[torch.arange(b, device=cuda), lens - 1]
        assert torch.equal(got[:, -1], last)


def test_mamba_scan_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.ones(1, 4, 2, 8, device=cuda)
    with pytest.raises(TypeError):
        ops.mamba_scan(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_scan(x.transpose(2, 3), x.transpose(2, 3))
    with pytest.raises(ValueError, match="both be"):
        ops.mamba_scan(x, x[:, :3])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_ssm_lm_on_card_matches_cpu(cuda, arch):
    """The smoke LM's prefill and two decode steps on the card against the
    CPU (plain versions), float32 on both: logits within 1e-4 x max|logit|,
    SSM states within 1e-4. Prefill launches the scan kernel once per Mamba
    layer (and, for jamba, flash and the dispatch positions); decode
    launches no scan."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config(arch).smoke()
    card = LM(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    host = LM(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(3)
    lens = np.array([30, 1, 17, 64], np.int32)
    toks = np.zeros((4, 64), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
    n_mamba = (cfg.n_layers if cfg.family == "ssm"
               else cfg.n_layers - cfg.n_layers // cfg.attn_every)
    c_card, c_host = card.init_cache(4, 80), host.init_cache(4, 80)
    ops.reset_launch_counts()
    lc, c_card = card.prefill(c_card, toks, lens)
    after_prefill = ops.launch_counts()
    assert after_prefill["mamba_scan"] == n_mamba
    if cfg.family == "hybrid":
        assert after_prefill["flash_attention"] == cfg.n_layers // \
            cfg.attn_every
        assert after_prefill["dispatch_positions"] > 0
    lh, c_host = host.prefill(c_host, toks, lens)
    for step in range(3):
        scale = lh.abs().max().item()
        assert (lc.cpu() - lh).abs().max().item() <= 1e-4 * scale, step
        nxt = lh.reshape(4, -1).argmax(-1).numpy().astype(np.int32)
        lc, c_card = card.decode_step(c_card, nxt[:, None], lens + step)
        lh, c_host = host.decode_step(c_host, nxt[:, None], lens + step)
    assert ops.launch_counts()["mamba_scan"] == n_mamba
    leaves = (lambda c: [t for k in sorted(c) for t in c[k]]
              if isinstance(c, dict) else list(c))
    for got, want in zip(leaves(c_card), leaves(c_host)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# bfloat16 flash backward: each gradient row (over hd) within 3e-2 of the
# plain version's in relative L2 norm and every element within 6e-2 (rtol
# and atol); float32 within 1e-4 x each gradient's max|.|
BWD_BF16_ROW_TOL = 3e-2
BWD_BF16_TOL = 6e-2
BWD_F32_TOL = 1e-4


def _rows_checked(want):
    """The rows the row bound reads: those whose norm is at least 1e-3 of
    the largest (a query that sees only its own key has dq = 0 exactly; its
    row is held by the element bound)."""
    norms = want.float().norm(dim=-1)
    return norms >= 1e-3 * norms.max()


@pytest.mark.parametrize("b,h,kv,s,hd,dtype,window,softcap,causal", [
    (2, 4, 2, 130, 64, torch.bfloat16, None, None, True),
    (1, 8, 4, 300, 128, torch.bfloat16, 100, None, True),
    (2, 4, 2, 200, 64, torch.bfloat16, None, 30.0, True),
    (1, 4, 2, 200, 256, torch.bfloat16, 50, None, True),
    (2, 4, 2, 150, 64, torch.bfloat16, None, None, False),
    (1, 4, 1, 70, 32, torch.bfloat16, None, None, True),
    (2, 4, 2, 100, 64, torch.float32, None, None, True),
    (2, 4, 2, 300, 64, torch.float32, 16, None, True),
    (2, 4, 2, 300, 64, torch.float32, None, 30.0, True),
    (1, 4, 2, 200, 256, torch.float32, 50, None, True),
    (1, 4, 1, 70, 32, torch.float32, None, None, True)])
def test_flash_backward_kernel_matches_plain(cuda, b, h, kv, s, hd, dtype,
                                             window, softcap, causal):
    g = torch.Generator().manual_seed(s + hd)
    q, do = (torch.randn(b, h, s, hd, generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, kv, s, hd, generator=g).to(cuda, dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    after = ops.launch_counts()
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert (after["flash_attention_bwd_tc"]
            - before["flash_attention_bwd_tc"]) == int(dtype == torch.bfloat16)
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        if dtype == torch.bfloat16:
            rows = _rows_checked(w)
            assert _row_rel_err(a[rows], w[rows]) <= BWD_BF16_ROW_TOL
            torch.testing.assert_close(a.float(), w.float(),
                                       rtol=BWD_BF16_TOL, atol=BWD_BF16_TOL)
        else:
            assert (a - w).abs().max().item() <= \
                BWD_F32_TOL * w.abs().max().item()


def test_flash_backward_tc_counter_and_repeat(cuda):
    """Every bfloat16 backward call runs the tensor-core kernels (counted
    once in ``flash_attention_bwd`` and in ``flash_attention_bwd_tc``), a
    float32 call the FMA ones (0 in ``flash_attention_bwd_tc``); two calls
    on the same inputs give the same bits (no atomics)."""
    g = torch.Generator().manual_seed(3)
    for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, do = (torch.randn(2, 8, 257, 64, generator=g).to(cuda, dtype)
                 for _ in range(2))
        k, v = (torch.randn(2, 2, 257, 64, generator=g).to(cuda, dtype)
                for _ in range(2))
        _, lse = flash.flash_attention_cuda(q, k, v, return_lse=True)
        ops.reset_launch_counts()
        first = flash.flash_attention_bwd_cuda(q, k, v, do, lse)
        again = flash.flash_attention_bwd_cuda(q, k, v, do, lse)
        counts = ops.launch_counts()
        assert counts["flash_attention_bwd"] == 2
        assert counts["flash_attention_bwd_tc"] == 2 * tc
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_bwd_tile_plans_are_the_kernels(cuda, dtype, hd):
    """The backward kernels' tiles and walks (their rule, run on the host)
    against ``bwd_tiles``, ``tile_plan`` and ``bwd_key_plan``."""
    bq, bk = flash.bwd_tiles(dtype, hd)
    assert flash.cuda_bwd_tiles(dtype, hd) == (bq, bk)
    for s in (1, 63, 65, 129, 700):
        for causal in (True, False):
            for window in (None, 1, 16, 100):
                for q0 in range(0, s, bq):
                    assert flash.cuda_bwd_tile_plan(
                        q0, bq, bk, s, causal, window) == flash.tile_plan(
                            q0, bq, bk, s, s, causal, window)
                for k0 in range(0, s, bk):
                    assert flash.cuda_bwd_key_plan(
                        k0, bq, bk, s, causal, window) == flash.bwd_key_plan(
                            k0, bq, bk, s, causal, window)


@pytest.mark.parametrize("shape,dtype", [((2, 37, 3, 36), torch.float32),
                                         ((1, 100, 2, 64), torch.bfloat16),
                                         ((1, 5, 2, 7), torch.float32),
                                         ((1, 2048, 16, 512), torch.float32)])
def test_mamba_backward_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator().manual_seed(shape[1])
    da = torch.rand(shape, generator=g).to(cuda, dtype)
    dbx = torch.randn(shape, generator=g).to(cuda, dtype)
    go = torch.randn(shape, generator=g).to(cuda)
    leaves = [da.clone().requires_grad_(True), dbx.clone().requires_grad_(
        True)]
    before = ops.launch_counts()["mamba_scan_bwd"]
    h = ops.mamba_scan(*leaves)
    got = torch.autograd.grad(h, leaves, go)
    assert ops.launch_counts()["mamba_scan_bwd"] == before + 1
    # the kernel sums in the plain version's order; a bfloat16 input gets
    # its gradient rounded to bfloat16, as autograd rounds the plain one
    want = [w.to(dtype).float() for w in ref.mamba_scan_bwd_ref(
        da, h.detach(), go)]
    for a, w in zip(got, want):
        assert a.dtype == dtype
        assert (a.float() - w).abs().max().item() <= \
            1e-5 * w.abs().max().item()


def test_granite_two_layer_train_step_on_card(cuda):
    """granite-moe-1b-a400m at full width, 2 layers, one train step with
    remat on the card: the loss and gradient norm finite, the step's
    launches the expected counts (2 flash forwards, 2 more in the remat
    recompute, 2 backwards; 4 dispatch-positions calls), and the
    parameters moved."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import init_state, make_train_step
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2)
    lm = LM(cfg, device=cuda)
    opt = AdamW()
    state = init_state(lm, opt, torch.Generator(device=cuda).manual_seed(0))
    step = make_train_step(lm, opt, warmup_cosine(3e-3, 0, 10), remat=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 1024)).astype(np.int32)
    before = lm.stages[0].attn.wq.w.detach().clone()
    ops.reset_launch_counts()
    state, m = step(state, {"tokens": tokens, "labels": tokens})
    counts = ops.launch_counts()
    assert np.isfinite(m["loss"].item()) and np.isfinite(
        m["grad_norm"].item())
    assert counts["flash_attention"] == counts["flash_attention_tc"] == 4
    assert counts["flash_attention_bwd"] == 2
    assert counts["flash_attention_bwd_tc"] == 2
    assert counts["dispatch_positions"] == 4
    assert counts["mamba_scan"] == counts["prefix_scan"] == 0
    assert not torch.equal(lm.stages[0].attn.wq.w.detach(), before)


def test_fp8_kv_cache_decode_on_card(cuda):
    """``tests/test_kv_cache_dtype.py``'s case on the card: qwen1.5-32b's
    smoke model (weights from the port's init, a CPU generator seeded 0:
    the JAX package's weights need JAX, which the card machine lacks)
    decodes 10 steps of 2 sequences with a ``float8_e4m3fn`` KV cache on
    the card and on the CPU: the reference's bounds between the two
    (greedy agreement at least 0.95, the largest logit gap below 1.0), and
    the card's fp8-against-float32 greedy agreement equal to the CPU's
    (``tests/test_torch_kv_cache_dtype.py`` holds the CPU's at the
    reference's bounds on the reference's weights)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    base = get_config("qwen1.5-32b").smoke()
    tokens = np.random.default_rng(1).integers(0, base.vocab_size, (2, 10))

    def decode(changes, device):
        cfg = dataclasses.replace(base, **changes)
        drawn = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        lm = LM(cfg, device=device)
        lm.load_state_dict(drawn.state_dict())
        cache = lm.init_cache(2, 20)
        out = []
        for t in range(10):
            logits, cache = lm.decode_step(cache, tokens[:, t:t + 1],
                                           np.full((2,), t))
            out.append(logits[:, 0].float().cpu().numpy())
        return cache.k.dtype, np.stack(out)

    fp8 = {"kv_cache_dtype": "float8_e4m3fn"}
    f32 = {"kv_cache_dtype": "float32", "dtype": "float32"}
    kind, card8 = decode(fp8, cuda)
    assert kind == torch.float8_e4m3fn
    _, host8 = decode(fp8, torch.device("cpu"))
    assert (card8.argmax(-1) == host8.argmax(-1)).mean() >= 0.95
    assert np.abs(card8 - host8).max() < 1.0
    _, card32 = decode(f32, cuda)
    _, host32 = decode(f32, torch.device("cpu"))
    assert (card8.argmax(-1) == card32.argmax(-1)).mean() == (
        host8.argmax(-1) == host32.argmax(-1)).mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_merge_on_card_matches_cpu(cuda, dtype):
    """Split decode's attention on the card: one token's queries against a
    cache of 64 positions cut by hand into 4 ranks' blocks of 16, each
    block's partial softmax (``attention.decode_partials``: rows of
    lengths 3, 20 and 47, so that blocks lie wholly past a length, and
    gemma3's sliding window of 16 across the blocks' edges) merged
    (``distributed.merge_blocks``, the algebra ``SeqSplit.merge_softmax``
    runs with its all-reduces), equal to the same merge on the CPU and to
    the softmax over the whole cache on the CPU: float32 within 1e-6,
    bfloat16 (the values weighed in bf16, as the LM's decode does) each
    output row within BF16_ROW_TOL."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.attention import decode_partials
    from repro_torch.models.distributed import merge_blocks

    cfg = dataclasses.replace(get_config("gemma3-4b").smoke(),
                              sliding_window=16)
    g = torch.Generator().manual_seed(4)
    b, n, kv, hd = 3, 64, cfg.n_kv_heads, cfg.head_dim_
    q = torch.randn(b, cfg.n_heads, hd, generator=g).to(dtype)
    k = torch.randn(b, n, kv, hd, generator=g).to(dtype)
    v = torch.randn(b, n, kv, hd, generator=g).to(dtype)
    lengths = torch.tensor([3, 20, 47])

    def merged(device):
        parts = [decode_partials(q.to(device), k[:, lo:lo + 16].to(device),
                                 v[:, lo:lo + 16].to(device),
                                 lengths.to(device), cfg, lo=lo,
                                 is_global=False)
                 for lo in range(0, n, 16)]
        return merge_blocks(*(torch.stack(t) for t in zip(*parts)))

    got, host = merged(cuda).cpu(), merged(torch.device("cpu"))
    m, s, o = decode_partials(q, k, v, lengths, cfg, is_global=False)
    whole = o / s[..., None]
    if dtype == torch.float32:
        torch.testing.assert_close(got, host, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
    else:
        assert _row_rel_err(got, host) <= BF16_ROW_TOL
        assert _row_rel_err(got, whole) <= BF16_ROW_TOL
