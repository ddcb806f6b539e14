"""``tests/test_system.py``'s cases, run against the port
(``_torch_mirror``: the reference file's own source, its ``repro``
imports pointed at ``repro_torch``)."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

from _torch_mirror import mirror

globals().update(mirror("test_system.py"))
