"""``tests/test_core_cost_trigger.py``'s cases, run against the port
(``_torch_mirror``: the reference file's own source, its ``repro``
imports pointed at ``repro_torch``). The reference's ``TpuCostModel()``
is the port's ``GpuCostModel`` at its own link and placement figures,
with the per-hop latency that has no data-sheet default stated here."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import functools

from _torch_mirror import mirror
from repro_torch.core import GpuCostModel

ALPHA = 2e-6    # s a hop; the ladder-invariance case holds for any value

globals().update(mirror(
    "test_core_cost_trigger.py",
    bind={"TpuCostModel": functools.partial(GpuCostModel, alpha=ALPHA)}))
