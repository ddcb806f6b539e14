"""``tests/test_core_cost_trigger.py``'s cases, run against the port
(``_torch_mirror``: the reference file's own source, its ``repro``
imports pointed at ``repro_torch``), all but the TPU cost model's: the
port leaves ``TpuCostModel`` out by design (``core/cost_model.py``)."""

from _torch_mirror import mirror

globals().update(mirror("test_core_cost_trigger.py",
                        skip=("test_tpu_cost_model_log_ladder_invariance",),
                        drop=("TpuCostModel",)))
