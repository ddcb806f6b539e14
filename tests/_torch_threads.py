"""Imported first by every port test module: one intra-op thread for
torch in the process. The suite runs as several pytest-xdist workers on
one CPU, and the port's tests compute on small tensors. At torch's
default of a thread per core, every worker's thread pool contends for the
same cores and spins while it waits: a smoke-size train step then takes
over ten times as long as on one thread. The ranks of ``_torch_ranks``
set the same."""

import torch

torch.set_num_threads(1)
