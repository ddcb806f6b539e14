"""The manifest loader: every configuration, traffic mix and per-layer
metric found by name, names and units checked, and BENCHMARK.json kept to
the benchmark's contract."""

from __future__ import annotations

import json

import pytest

from portbench.manifest import (BENCH_DIR, ROOT, check_name, check_unit,
                                load_cell, load_manifest, load_module,
                                metrics_for)


def test_every_cell_finds_its_files():
    manifest = load_manifest()
    for entry in manifest["workloads"]:
        cell = load_cell(entry["name"], manifest)
        assert cell.chips == entry["chips"] == 1
        load_module("runners", cell.config["runner"])
        ref = load_module("references", cell.config["reference"])
        assert callable(ref.simulate)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for entry in manifest["per_layer"]:
        assert callable(load_module("metrics", entry["name"]).read)
    for entry in manifest["configs"]:
        assert (ROOT / entry["file"]).is_file()
        assert entry["file"] == f"portbench/configs/{entry['name']}.json"


def test_contract_shape():
    manifest = load_manifest()
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "sweep_tasks_per_s"
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in manifest["workloads"]:
        assert w["config"] in {c["name"] for c in manifest["configs"]}
        assert len(w["why"]) <= 200
    assert len(json.dumps(manifest)) < 64 * 1024


def test_names_and_units_are_checked():
    for good in ("setup_s", "clusterdata-12.5k.poisson", "_x", "9a"):
        assert check_name(good) == good
    for bad in ("a b", "a/b", "a,b", ".a", "", "x" * 65, "μs", "-a"):
        with pytest.raises(ValueError):
            check_name(bad)
    for good in ("tasks/s", "%", "GiB", "ms", "launches"):
        assert check_unit(good) == good
    for bad in ("tasks per s", "", "μs", "x" * 17):
        with pytest.raises(ValueError):
            check_unit(bad)


def test_bad_manifest_is_refused(tmp_path):
    manifest = load_manifest()
    manifest["per_layer"][0]["unit"] = "ms a sweep"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError):
        load_manifest(path)
    manifest = load_manifest()
    manifest["workloads"][0]["name"] = "has space"
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError):
        load_manifest(path)


def test_unknown_names_are_not_found():
    with pytest.raises(KeyError):
        load_cell("no-such-cell.poisson")
    with pytest.raises(FileNotFoundError):
        load_module("metrics", "no_such_metric")
    with pytest.raises(ValueError):
        load_module("metrics", "../run")


def test_metrics_for_a_cell():
    entries = [{"name": "a"}, {"name": "b", "workloads": ["x"]}]
    assert [m["name"] for m in metrics_for(entries, "x")] == ["a", "b"]
    assert [m["name"] for m in metrics_for(entries, "y")] == ["a"]


def test_added_cell_needs_no_edit(tmp_path):
    """A new cell is a manifest entry and files of its own."""
    manifest = load_manifest()
    for kind in ("runners", "references", "metrics", "configs"):
        (tmp_path / kind).symlink_to(BENCH_DIR / kind)
    (tmp_path / "traffic").mkdir()
    traffic = json.loads((BENCH_DIR / "traffic"
                          / "clusterdata-12.5k.poisson.json").read_text())
    (tmp_path / "traffic" / "alibaba-4k.poisson.json").write_text(
        json.dumps(traffic))
    manifest["workloads"].append({"name": "alibaba-4k.poisson",
                                  "config": "alibaba-4k",
                                  "traffic": "poisson", "chips": 1,
                                  "why": "steady twin"})
    cell = load_cell("alibaba-4k.poisson", manifest, tmp_path)
    assert cell.config["n_nodes"] == 4000 and cell.traffic["load"] == 48 / 91
