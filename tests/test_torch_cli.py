"""The port's lab CLI (``python -m repro_torch.lab``) held against the JAX
package's (``python -m repro.lab``) on the CPU.

Each subcommand runs in both packages on the same files: ``template`` (all
five presets), ``run`` (events, legacy, online, a federation preset),
``sweep`` (on the event engine, and on the batched engine with ``--device
cpu``), ``backends``, ``serve`` (feeds, fixed steps, the decision stream,
the metrics stream and endpoint) and ``trace``. What they print and the
JSON files they write are equal, byte for byte, except the batched sweep's
metrics, held at rtol 1e-6 (the JAX package's own tolerance for that
engine) and the metrics endpoint's URL (a free port each). The CLI cases
of ``tests/test_lab.py``, ``tests/test_online.py``, ``tests/test_ops.py``,
``tests/test_traces.py`` and ``tests/test_federation.py`` run on the port.
``--device`` is the port's own: a batched run without it needs the GPU.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (one torch thread a worker)

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.lab import cli as jcli  # noqa: E402
from repro_torch import lab  # noqa: E402
from repro_torch.lab import cli  # noqa: E402
from repro_torch.obs import parse_openmetrics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
EXCERPT = ROOT / "benchmarks" / "data" / "google_excerpt_10k.csv.gz"
TINY = Path(__file__).parent / "data"
G_EVENTS = TINY / "google_tiny_events.csv"
G_CONSTRAINTS = TINY / "google_tiny_constraints.csv"
POWERS = (3.0, 1.0, 7.0, 2.0)


def _scenario(**overrides) -> lab.Scenario:
    """``tests/test_lab.py``'s scenario."""
    fields = dict(
        cluster=lab.ClusterSpec(powers=POWERS, bandwidth=256.0),
        workload=lab.WorkloadSpec(process="poisson", horizon=100.0,
                                  work_mean=6.0, params={"rate": 6.0}),
        policy=lab.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.1}),
        seed=0)
    fields.update(overrides)
    return lab.Scenario(**fields)


def _serve_scenario() -> lab.Scenario:
    """``tests/test_online.py``'s serve scenario."""
    return lab.Scenario(
        cluster=lab.ClusterSpec(n_nodes=3, power_seed=0),
        workload=lab.WorkloadSpec(process="poisson", horizon=10.0,
                                  params={"rate": 1.0}),
        policy=lab.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.05}),
        seed=2, name="serve-smoke")


def _ops_scenario(*, rate, horizon) -> lab.Scenario:
    """``tests/test_ops.py``'s scenario."""
    return lab.Scenario(
        name="ops-test",
        cluster=lab.ClusterSpec(n_nodes=8, power_seed=3),
        workload=lab.WorkloadSpec(process="poisson", horizon=horizon,
                                  work_mean=5.0, params={"rate": rate}),
        policy=lab.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.05}))


def _write(path: Path, text: str) -> str:
    path.write_text(text)
    return str(path)


def _both(tmp_path, capsys, argv):
    """Run ``argv(outdir)`` through each package's CLI, each writing into
    its own folder; returns ``{"ref": ..., "port": ...}`` with the exit
    code, stdout, stderr and every file written."""
    got = {}
    for tag, main in (("ref", jcli.main), ("port", cli.main)):
        out = tmp_path / tag
        out.mkdir()
        capsys.readouterr()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = main(argv(out))
        io = capsys.readouterr()
        got[tag] = {
            "rc": rc,
            "out": io.out.replace(str(out), "<out>"),
            "err": io.err.replace(str(out), "<out>"),
            "files": {p.name: p.read_text() for p in sorted(out.iterdir())},
        }
    return got


def _assert_same(got) -> None:
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# template
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(cli.PRESETS))
def test_template_prints_the_reference_presets(preset, tmp_path, capsys):
    assert sorted(cli.PRESETS) == sorted(jcli.PRESETS)
    got = _both(tmp_path, capsys, lambda _: ["template", "--preset", preset])
    _assert_same(got)
    text = got["port"]["out"]
    spec = (lab.Federation if "federation" in preset else lab.Scenario
            ).from_json(text)
    assert spec.to_json() + "\n" == text


def test_cli_template_run_round_trip(tmp_path, capsys):
    assert cli.main(["template", "--preset", "basic"]) == 0
    text = capsys.readouterr().out
    sc_file = _write(tmp_path / "scenario.json", text)
    scenario = lab.Scenario.from_json(text)
    out = tmp_path / "result.json"
    assert cli.main(["run", sc_file, "--backend", "events",
                     "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert len(payload) == 1
    result = lab.RunResult.from_dict(payload[0])
    assert result.fingerprint == scenario.fingerprint()
    assert tuple(result.metrics) == lab.METRIC_SCHEMA
    assert result.metrics["completed"] == result.metrics["arrived"] > 0


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["events", "legacy", "online"])
def test_run_writes_the_reference_result(backend, tmp_path, capsys):
    sc = _scenario(policy=lab.PolicySpec("psts", params={"floor": 0.1}))
    f = _write(tmp_path / "sc.json", sc.to_json())
    got = _both(tmp_path, capsys, lambda out: [
        "run", f, "--backend", backend, "--out", str(out / "r.json")])
    _assert_same(got)
    [r] = json.loads(got["port"]["files"]["r.json"])
    assert r["backend"] == backend
    if backend != "legacy":
        assert r["metrics"]["completed"] == r["metrics"]["arrived"] > 0


def test_run_online_equals_events_byte_for_byte(tmp_path, capsys):
    f = _write(tmp_path / "sc.json", _scenario().to_json())
    runs = {}
    for backend in ("events", "online"):
        out = tmp_path / f"{backend}.json"
        assert cli.main(["run", f, "--backend", backend,
                         "--out", str(out)]) == 0
        runs[backend] = json.loads(out.read_text())[0]
    capsys.readouterr()
    assert json.dumps(runs["online"]["metrics"]) == \
        json.dumps(runs["events"]["metrics"])
    assert runs["online"]["backend_options"]["model"] == \
        "incremental-service"


def test_run_federation_preset_as_the_reference(tmp_path, capsys):
    assert cli.main(["template", "--preset", "geo-federation"]) == 0
    f = _write(tmp_path / "fed.json", capsys.readouterr().out)
    got = _both(tmp_path, capsys, lambda out: [
        "run", f, "--out", str(out / "r.json")])
    _assert_same(got)
    [r] = json.loads(got["port"]["files"]["r.json"])
    assert r["backend"] == "federated"
    assert r["fingerprint"] == lab.Federation.from_json(
        Path(f).read_text()).fingerprint()
    assert r["metrics"]["completed"] == r["metrics"]["arrived"]
    assert r["extras"]["wan"]["migrations"] > 0


def test_run_trace_scenario_and_instruments(tmp_path, capsys):
    sc = lab.Scenario(
        name="google-tiny",
        cluster=lab.ClusterSpec(powers=POWERS,
                                attrs={"machine_class": (0, 1, 2, 3),
                                       "ssd": (0, 1, 0, 1)}),
        workload=lab.WorkloadSpec(
            trace=lab.TraceRef(path=str(G_EVENTS), format="google",
                               params={"constraints_path":
                                       str(G_CONSTRAINTS)}),
            horizon=None),
        policy=lab.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.05}))
    f = _write(tmp_path / "sc.json", sc.to_json())
    got = _both(tmp_path, capsys, lambda out: [
        "run", f, "--out", str(out / "r.json")])
    _assert_same(got)
    [r] = json.loads(got["port"]["files"]["r.json"])
    assert r["extras"]["wait_by_tier"]["0"]["completed"] == 1
    # --probe-every's series equal the reference's; the Chrome trace of
    # --trace-out has the same events (its wall-clock latencies aside)
    (tmp_path / "obs").mkdir()
    got = _both(tmp_path / "obs", capsys, lambda out: [
        "run", f, "--probe-every", "1.0", "--trace-out",
        str(out / "t.json"), "--out", str(out / "r.json")])
    assert got["port"]["out"] == got["ref"]["out"]
    assert json.loads(got["port"]["files"]["r.json"])[0]["extras"][
        "obs"]["probes"] == json.loads(got["ref"]["files"]["r.json"])[0][
        "extras"]["obs"]["probes"]
    events = [json.loads(got[t]["files"]["t.json"])["traceEvents"]
              for t in ("port", "ref")]
    assert events[0] == events[1]


def test_run_flags_refused_as_in_the_reference(tmp_path, capsys):
    f = _write(tmp_path / "sc.json", _scenario().to_json())
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit, match="slot width"):
            main(["run", f, "--dt", "0.5"])
    # --device picks where the batched/federated backends run; the host
    # backends take none
    for backend in ("events", "legacy", "online"):
        with pytest.raises(SystemExit, match="host code"):
            cli.main(["run", f, "--backend", backend, "--device", "cpu"])


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------

def test_sweep_on_the_event_engine_as_the_reference(tmp_path, capsys):
    f = _write(tmp_path / "sc.json", _scenario().to_json())
    got = _both(tmp_path, capsys, lambda out: [
        "sweep", f, "--grid", "seed=0:3", "--out", str(out / "s.json")])
    _assert_same(got)
    payload = json.loads(got["port"]["files"]["s.json"])
    assert [p["backend"] for p in payload] == ["events"] * 3


def test_sweep_on_the_batched_engine_within_rtol(tmp_path, capsys):
    f = _write(tmp_path / "sc.json", _scenario().to_json())
    outs = {}
    for tag, main, extra in (("ref", jcli.main, []),
                             ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.json"
        assert main(["sweep", f, "--grid", "seed=0:10", "--batch-threshold",
                     "8", "--out", str(out), *extra]) == 0
        outs[tag] = json.loads(out.read_text())
    capsys.readouterr()
    assert len(outs["port"]) == 10
    assert {p["backend"] for p in outs["port"]} == {"batched"}
    for got, want in zip(outs["port"], outs["ref"]):
        assert got.keys() == want.keys()
        assert got["fingerprint"] == want["fingerprint"]
        assert got["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():
            if isinstance(v, float):
                np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6,
                                           err_msg=k)
            else:
                assert got["metrics"][k] == v, k


def test_sweep_without_device_needs_the_gpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    f = _write(tmp_path / "sc.json", _scenario().to_json())
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["sweep", f, "--grid", "seed=0:8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", f, "--backend", "batched"])
    # below the batch threshold the sweep runs on the host engine
    assert cli.main(["sweep", f, "--grid", "seed=0:2"]) == 0
    capsys.readouterr()


def test_cli_grid_rejects_float_ranges_with_hint():
    with pytest.raises(SystemExit, match="comma list"):
        cli._parse_grid(["policy.params.floor=0.05:0.1"])
    assert cli._parse_grid(["seed=0:6:2"]) == {"seed": [0, 2, 4]}
    assert cli._parse_grid(["policy.params.floor=0.05,0.1"]) == {
        "policy.params.floor": [0.05, 0.1]}


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["scenario", "federation", "dag"])
def test_backends_report_equals_the_reference(spec, tmp_path, capsys):
    if spec == "federation":
        assert cli.main(["template", "--preset", "planet-federation"]) == 0
        text = capsys.readouterr().out
    elif spec == "dag":
        text = _scenario(workload=lab.WorkloadSpec(
            horizon=20.0, params={"rate": 1.0},
            dag={"kind": "chain"})).to_json()
    else:
        text = _scenario().to_json()
    f = _write(tmp_path / "sc.json", text)
    # both CLIs register the online backend at import: five lines each
    got = _both(tmp_path, capsys, lambda _: ["backends", f])
    _assert_same(got)
    lines = got["port"]["out"].splitlines()
    assert [ln.split()[0] for ln in lines] == sorted(lab.BACKENDS) == [
        "batched", "events", "federated", "legacy", "online"]


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def test_cli_serve_streams_decisions(tmp_path, capsys):
    f = _write(tmp_path / "sc.json", _serve_scenario().to_json())
    feed = _write(tmp_path / "tasks.jsonl",
                  '{"t": 1.0, "work": 2.0}\n{"t": 4.0, "work": 1.0}\n')
    got = _both(tmp_path, capsys, lambda out: [
        "serve", f, "--feed", feed, "--decisions-out",
        str(out / "decisions.jsonl"), "--out", str(out / "result.json")])
    _assert_same(got)
    assert "served" in got["port"]["err"]
    files = got["port"]["files"]
    lines = [json.loads(x) for x in files["decisions.jsonl"].splitlines()]
    assert lines and all({"seq", "t", "kind"} <= set(d) for d in lines)
    payload = json.loads(files["result.json"])
    m = payload["metrics"]
    assert m["completed"] == m["arrived"] > 2  # workload + both feed tasks
    assert payload["decisions"]["complete"] == m["completed"]
    assert sum(1 for d in lines if d["kind"] == "complete") == m["completed"]


def test_cli_serve_feed_only_fixed_step(tmp_path, capsys):
    f = _write(tmp_path / "sc.json", _serve_scenario().to_json())
    feed = _write(tmp_path / "tasks.jsonl",
                  '{"t": 0.5, "work": 1.0}\n{"t": 1.5, "work": 2.0}\n')
    # decisions on stdout, as the reference prints them
    got = _both(tmp_path, capsys, lambda out: [
        "serve", f, "--no-workload", "--feed", feed, "--step", "0.5",
        "--out", str(out / "result.json")])
    _assert_same(got)
    m = json.loads(got["port"]["files"]["result.json"])["metrics"]
    assert m["arrived"] == m["completed"] == 2
    assert sum(json.loads(x)["kind"] == "complete"
               for x in got["port"]["out"].splitlines()) == 2


def test_serve_cli_metrics_stream(tmp_path, capsys):
    f = _write(tmp_path / "sc.json",
               _ops_scenario(rate=2.0, horizon=15.0).to_json())
    got = _both(tmp_path, capsys, lambda out: [
        "serve", f, "--decisions-out", str(out / "dec.jsonl"),
        "--metrics-out", str(out / "metrics.jsonl"), "--metrics-every", "5"])
    _assert_same(got)
    rows = [json.loads(line) for line in
            got["port"]["files"]["metrics.jsonl"].splitlines()]
    assert len(rows) >= 2
    assert rows[0]["t"] <= rows[-1]["t"]
    done = [r["metrics"]["sched_tasks_completed_total"]["samples"][""]
            for r in rows]
    assert done == sorted(done)  # counters are monotone over the stream
    with pytest.raises(SystemExit):
        cli.main(["serve", f, "--metrics-every", "0"])
    with pytest.raises(SystemExit, match="step"):
        cli.main(["serve", f, "--step", "0"])


def test_serve_cli_metrics_port(tmp_path, capsys):
    f = _write(tmp_path / "sc.json",
               _ops_scenario(rate=1.0, horizon=5.0).to_json())
    got = _both(tmp_path, capsys, lambda out: [
        "serve", f, "--decisions-out", str(out / "d.jsonl"),
        "--metrics-port", "0", "--out", str(out / "r.json")])
    for tag in ("ref", "port"):
        err = got[tag]["err"].splitlines()
        assert err[0].startswith("metrics endpoint: http://")
        got[tag]["err"] = err[1:]  # a free port each
    _assert_same(got)


def test_serve_cli_endpoint_scrape_parses(tmp_path, capsys, monkeypatch):
    """One scrape of the live endpoint, taken while the service runs."""
    import urllib.request

    from repro_torch.obs import export
    seen = []
    real = export.MetricsHTTPServer

    class Scraped(real):
        def close(self):
            seen.append(urllib.request.urlopen(self.url).read().decode())
            super().close()

    monkeypatch.setattr("repro_torch.obs.MetricsHTTPServer", Scraped)
    f = _write(tmp_path / "sc.json",
               _ops_scenario(rate=1.0, horizon=5.0).to_json())
    out = tmp_path / "r.json"
    assert cli.main(["serve", f, "--decisions-out", str(tmp_path / "d"),
                     "--metrics-port", "0", "--out", str(out)]) == 0
    capsys.readouterr()
    [text] = seen
    fams = parse_openmetrics(text)
    assert fams["sched_completed"]["samples"][0][2] == \
        json.loads(out.read_text())["metrics"]["completed"]


def test_serve_refuses_a_federation(tmp_path, capsys):
    assert cli.main(["template", "--preset", "geo-federation"]) == 0
    f = _write(tmp_path / "fed.json", capsys.readouterr().out)
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit, match="single Scenario"):
            main(["serve", f])


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ["--format", "google"],
    ["--format", "google", "--eviction-mode", "end", "--scale", "2.0",
     "--seed", "3"],
], ids=["excerpt", "scaled"])
def test_trace_report_equals_the_reference(args, tmp_path, capsys):
    got = _both(tmp_path, capsys, lambda _: ["trace", str(EXCERPT), *args])
    _assert_same(got)
    assert "tasks        " in got["port"]["out"]


def test_cli_trace_info_and_convert(tmp_path, capsys):
    got = _both(tmp_path, capsys, lambda out: [
        "trace", str(G_EVENTS), "--format", "google", "--param",
        f"constraints_path={G_CONSTRAINTS}", "--deps",
        "--out", str(out / "norm.csv"),
        "--out-constraints", str(out / "norm.json")])
    _assert_same(got)
    text = got["port"]["out"]
    assert "tasks        4" in text
    assert "constraints  3 row(s)" in text
    from repro_torch.traces import load_normalized_csv
    back = load_normalized_csv(str(tmp_path / "port" / "norm.csv"),
                               constraints_path=str(
                                   tmp_path / "port" / "norm.json"))
    assert back.m == 4 and back.constraints.k == 3


def test_cli_trace_eviction_mode_and_machine_events(tmp_path, capsys):
    events = _write(tmp_path / "events.csv",
                    "1000000,,7,0,,0,u,0,9,0.5,0.2,\n"
                    "2000000,,7,0,,1,u,0,9,0.5,0.2,\n"
                    "5000000,,7,0,,2,u,0,9,0.5,0.2,\n"
                    "6000000,,7,0,,1,u,0,9,0.5,0.2,\n"
                    "10000000,,7,0,,4,u,0,9,0.5,0.2,\n")
    mach = _write(tmp_path / "machines.csv",
                  "0,1,0,,1.0,0.5\n4000000,1,2,,0.5,0.5\n")
    got = _both(tmp_path, capsys, lambda _: [
        "trace", events, "--format", "google", "--machine-events", mach])
    _assert_same(got)
    out = got["port"]["out"]
    assert "evictions    1 requeue event(s), 0 task(s) end evicted" in out
    assert "machines     1: 0 failure(s), 0 join(s), 1 resize(s)" in out
    assert cli.main(["trace", events, "--format", "google",
                     "--eviction-mode", "end"]) == 0
    assert "evictions    0 requeue event(s)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="google"):
        cli.main(["trace", events, "--eviction-mode", "end"])


# ---------------------------------------------------------------------------
# python -m repro_torch.lab
# ---------------------------------------------------------------------------

def test_python_dash_m_runs_and_loads_no_jax(tmp_path):
    f = _write(tmp_path / "sc.json", _scenario().to_json())
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.lab", "run",
         f, "--backend", "online", "--out", str(tmp_path / "r.json")],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "wrote 1 result(s)" in out.stdout
    # -X importtime lists every module the run imported, one a line
    imported = [ln.rsplit("|", 1)[-1].strip()
                for ln in out.stderr.splitlines()
                if ln.startswith("import time:")]
    assert "repro_torch.lab.cli" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    [r] = json.loads((tmp_path / "r.json").read_text())
    assert r["backend"] == "online"
    # importing the entry module runs nothing
    probe = subprocess.run(
        [sys.executable, "-c", "import repro_torch.lab.__main__"],
        env=env, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0 and probe.stdout == ""
