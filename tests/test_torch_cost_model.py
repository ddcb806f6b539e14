"""``repro_torch.core.GpuCostModel`` against the JAX package's
``TpuCostModel``. Built with the reference's field values, the port's model
gives exactly (``==``) what the reference gives for each method, over a grid
of node counts, embedding dimensions, payloads, migrated bytes and task
counts; its own defaults are the H100 SXM data-sheet figures."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import dataclasses

import pytest

import repro_torch.core
from repro.core.cost_model import TpuCostModel
from repro.core.hypergrid import factorize, optimal_dim
from repro_torch.core import GpuCostModel
from repro_torch.core.cost_model import FP64_FLOP_RATE, NDR_LINK_BW
from repro_torch.launch.roofline import HW

NODES = (1, 2, 3, 7, 8, 12, 64, 255, 256, 1000, 1024, 12500)
PAYLOADS = (0.0, 64.0, 1e6)
MOVED = (0.0, 1e9)
TASKS = (0, 4000, 1378880)


def _dims(n):
    return (None, 1, 2, optimal_dim(n))


GRID = [(n, d) for n in NODES for d in _dims(n)]


def _models():
    ref = TpuCostModel()
    return ref, GpuCostModel(**dataclasses.asdict(ref))


@pytest.mark.parametrize("n,d", GRID)
def test_scan_time_equals_the_reference(n, d):
    ref, port = _models()
    dims = factorize(n, optimal_dim(n) if d is None else d)
    for payload in PAYLOADS:
        assert port.scan_time(dims, payload) == ref.scan_time(dims, payload)


@pytest.mark.parametrize("n,d", GRID)
def test_migrate_time_equals_the_reference(n, d):
    ref, port = _models()
    dims = factorize(n, optimal_dim(n) if d is None else d)
    for moved in MOVED:
        assert port.migrate_time(dims, moved) == ref.migrate_time(dims, moved)
    assert port.migrate_time((), 1e9) == ref.migrate_time((), 1e9) == 0.0


@pytest.mark.parametrize("n,d", GRID)
def test_rebalance_cost_equals_the_reference(n, d):
    ref, port = _models()
    for payload in PAYLOADS:
        for moved in MOVED:
            for m in TASKS:
                kw = dict(d=d, scan_payload_bytes=payload, moved_bytes=moved,
                          m_tasks=m)
                assert port.rebalance_cost(n, **kw) == \
                    ref.rebalance_cost(n, **kw), kw


def test_defaults_are_the_h100_data_sheet_figures():
    model = GpuCostModel(alpha=2e-6)
    assert model.link_bw == NDR_LINK_BW == HW["ib_bw"] == 50e9
    assert model.flop_rate == FP64_FLOP_RATE == 34e12
    with pytest.raises(TypeError):
        GpuCostModel()      # the per-hop latency has no data-sheet default
    with pytest.raises(dataclasses.FrozenInstanceError):
        model.alpha = 0.0
    assert "GpuCostModel" in repro_torch.core.__all__
    assert repro_torch.core.GpuCostModel is GpuCostModel
