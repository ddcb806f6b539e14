"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the configuration's file names the runner that runs it. A metric applies to
a cell when its ``workloads`` list names the cell, or when it has no such
list. Names and units are checked here, so a file with a name that could not
be a file name, or a unit with a space, is refused before a run.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

__all__ = ["ROOT", "BENCH_DIR", "Cell", "load_manifest", "load_cell",
           "metrics_for", "load_module", "check_name", "check_unit"]

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str, what: str = "name") -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r}: a name is 1 to 64 of A-Z a-z "
                         f"0-9 _ . - and starts with a letter, digit or _")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not _UNIT.fullmatch(unit):
        raise ValueError(f"unit {unit!r}: a unit is 1 to 16 of A-Z a-z 0-9 "
                         f"_ / % . -")
    return unit


@dataclass(frozen=True)
class Cell:
    """One workload of the manifest, with its configuration and traffic."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: tuple      # the manifest's metric entries for this cell
    per_layer: tuple


def load_manifest(path: Path | None = None) -> dict:
    path = ROOT / "BENCHMARK.json" if path is None else Path(path)
    manifest = json.loads(path.read_text())
    for key in ("workloads", "configs", "end_to_end", "per_layer"):
        for entry in manifest[key]:
            check_name(entry["name"], f"{key} entry")
    for entry in manifest["end_to_end"] + manifest["per_layer"]:
        check_unit(entry["unit"])
    for entry in manifest["workloads"]:
        check_name(entry["config"], "config")
        check_name(entry["traffic"], "traffic")
    return manifest


def metrics_for(entries, cell: str) -> tuple:
    """The metric entries that apply to ``cell``."""
    return tuple(m for m in entries
                 if "workloads" not in m or cell in m["workloads"])


def load_cell(name: str, manifest: dict | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name``: its manifest entry, ``configs/<config>.json`` and
    ``traffic/<cell>.json``."""
    manifest = load_manifest() if manifest is None else manifest
    check_name(name, "workload")
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json "
                       f"(have {[w['name'] for w in manifest['workloads']]})")
    entry = found[0]
    config = json.loads((bench_dir / "configs"
                         / f"{entry['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic"
                          / f"{name}.json").read_text())
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"], traffic_name=entry["traffic"],
                config=config, traffic=traffic,
                end_to_end=metrics_for(manifest["end_to_end"], name),
                per_layer=metrics_for(manifest["per_layer"], name))


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """``<bench_dir>/<kind>/<name>.py`` as a module (a metric's reader, a
    runner, a reference), found by name whatever characters it holds."""
    check_name(name, kind)
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
