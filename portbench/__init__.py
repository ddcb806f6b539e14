"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell once::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json`` — a deployment, with the runner that runs it and
  the plain reference that judges it;
* ``traffic/<cell>.json`` — the parameters of a cell's traffic mix, read by
  the general generator in ``gen.py``;
* ``metrics/<metric>.py`` — a reader with ``read(trace) -> float | None``;
* ``runners/<runner>.py`` — the set-up, the window and the check of one kind
  of system under test;
* ``references/<reference>.py`` — a plain NumPy implementation of the same
  semantics, which imports nothing of the program.

The yardstick (generators, references, byte counts and peaks) lives here and
not in the program, so a change to the program cannot move it.
"""
