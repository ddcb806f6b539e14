"""``launch.dryrun`` on the decode_32k cells of granite-moe-1b-a400m,
olmo-1b and jamba-v0.1-52b and granite's prefill_32k cell (bf16 weights
and the KV/SSM cache placed by the sharding plans), held as
``test_torch_dryrun.py`` holds the train cells; the CLI writes its
records and ``launch.summarize`` prints the JAX package's table of them;
``roofline.collective_stats`` prices collectives with the JAX parser's
ring conventions. The serve cells compute each model rank's share from its
block of the cache: granite's FLOPs a rank fall at least 8x from what
every rank computed when prefill and decode gathered every weight whole
and attended the whole cache (1.8242e11 decode, 2.7058e14 prefill), its
useful ratios rise by the same factor, and its state bytes a rank are the
plan's."""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import json

import jax

jax.experimental.enable_x64 = jax.enable_x64   # see test_torch_kernels.py

import pytest  # noqa: E402

from _torch_dryrun_checks import check_record  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import summarize as jsum  # noqa: E402
from repro_torch.launch import dryrun, roofline, summarize  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "olmo-1b", "jamba-v0.1-52b"]
CELLS = [(arch, "decode_32k") for arch in ARCHS] + [
    ("granite-moe-1b-a400m", "prefill_32k")]
# granite's FLOPs a rank with every weight gathered whole and the whole
# cache attended on every rank, and its state bytes a rank (the plan's)
WHOLE_FLOPS = {"decode_32k": 1.8242e11, "prefill_32k": 2.7058e14}
STATE_BYTES = {"decode_32k": 821_856_256, "prefill_32k": 217_876_480}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape in CELLS:
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                     "--out", str(out)])
    return out, summarize.load_records(str(out))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell(records, arch):
    out, recs = records
    rec = json.loads((out / f"{arch}__decode_32k__single.json").read_text())
    assert rec in recs
    check_record(rec)
    assert rec["kind"] == "decode"


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_granite_serve_cells_compute_a_ranks_share(records, shape):
    out, _ = records
    rec = json.loads((out / f"granite-moe-1b-a400m__{shape}__single.json"
                      ).read_text())
    check_record(rec)
    assert rec["kind"] == shape.split("_")[0]
    flops = rec["cost"]["flops"]
    assert flops <= WHOLE_FLOPS[shape] / 8
    useful = rec["roofline"]["useful_compute_ratio"]
    assert useful * flops == pytest.approx(
        rec["roofline"]["model_flops"] / rec["n_devices"])
    assert rec["memory"]["state_bytes"] == STATE_BYTES[shape]


def test_summarize_prints_the_references_table(records, capsys):
    out, recs = records
    assert summarize.table(recs) == jsum.table(recs)
    assert summarize.table(recs).splitlines()[0] == (
        "| arch | shape | mesh | state GiB/dev | t_compute | t_mem | t_coll | "
        "dominant | useful | roofline | bw-frac |")
    picks = summarize.pick_hillclimb(recs)
    assert picks == jsum.pick_hillclimb(recs)
    assert {picks["worst_roofline"], picks["most_collective"]} <= {
        f"{a}/{s}" for a, s in CELLS}
    summarize.main(["--dir", str(out)])
    assert "4 cells" in capsys.readouterr().out


@pytest.mark.parametrize("kind,hlo_kind", [
    ("all-gather", "all-gather"), ("all-reduce", "all-reduce"),
    ("reduce-scatter", "reduce-scatter"), ("all-to-all", "all-to-all"),
    ("collective-permute", "collective-permute")])
@pytest.mark.parametrize("group", [2, 16])
def test_collective_stats_follow_the_reference(kind, hlo_kind, group):
    line = (f"  %op.1 = f32[512,2048]{{1,0}} {hlo_kind}(f32[64,2048] %x), "
            f"replica_groups=[{256 // group},{group}]<=[256]")
    want = jroof.collective_stats(line)
    got = roofline.collective_stats([{"kind": kind, "bytes": 512 * 2048 * 4,
                                      "group": group}])
    assert got == want
