"""``launch.dryrun`` on the train_4k cells of granite-moe-1b-a400m,
olmo-1b and jamba-v0.1-52b on the single-pod mesh (a one-process world of
256 ranks on the ``fake`` backend, the LM on ``meta``), held against the
JAX package's shape logic (``_torch_dryrun_checks``): ``model_flops``,
``n_params`` and ``n_active_params`` equal the JAX functions' exactly;
the state bytes per device equal the sum of the JAX specs' shard shapes
(each dim divided by the product of its axes' sizes) times the itemsizes,
and the argument bytes add the device's rows of the batch; the record
carries every key of the reference's; ``roofline_fraction`` and
``useful_compute_ratio`` are finite, the latter at most 1.05. Not held:
XLA's cost figures (the port counts FLOPs exactly on meta tensors and
records collectives as the step issues them).

The step computes each model-axis rank's share (heads, ff columns,
experts, vocabulary columns, Mamba channels): granite's
``useful_compute_ratio`` on the (16, 16) mesh is at least 3x the 0.0290
of the step that computed every rank's rows whole (0.4407 measured on the
host with the split, each rank projecting only the KV head its query head
reads), and the activations' all-reduces over ``model`` show in its
collectives."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import pytest  # noqa: E402

from _torch_dryrun_checks import check_record  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmo-1b",
                                  "jamba-v0.1-52b"])
def test_train_cell(arch):
    rec = dryrun.lower_cell(arch, "train_4k", False)
    check_record(rec)
    assert rec["kind"] == "train"
    assert rec["memory"]["alias_bytes"] == rec["memory"]["state_bytes"]
    # the step's collectives: weight gathers and gradient sums
    assert {"all-gather", "all-reduce"} <= set(rec["collectives"]["by_kind"])
    if arch == "granite-moe-1b-a400m":
        assert rec["roofline"]["useful_compute_ratio"] >= 3 * 0.0290
        # the split's activations: (rows, 4096, d) summed over model
        rows = 256 // 16
        assert any(c["kind"] == "all-reduce" and c["group"] == 16
                   and c["shape"] == [rows, 4096, 1024]
                   for c in rec["collective_log"])
