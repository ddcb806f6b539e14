"""The port's real-trace ingestion (``repro_torch.traces``) and the lab's
trace scenarios held against the JAX package's ``repro.traces`` on the CPU.

Parsing, the trace-scale synthesizer and the event engine run the same numpy
calls in the same order in both packages, so equality is exact: every
``TraceSchema`` field, every ``hash_attr_value`` code, every scaled trace,
every fingerprint, the events replay's ``Metrics.summary()`` with its
per-tier waits and churn census, and every eligibility reason. The batched
backend is held at rtol 1e-6, as everywhere else in the port.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import dataclasses
import gzip
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

from repro import lab as jlab  # noqa: E402
from repro import traces as jtraces  # noqa: E402
from repro_torch import lab  # noqa: E402
from repro_torch import traces  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks" / "data"
EXCERPT = str(BENCH / "google_excerpt_10k.csv.gz")
EXCERPT_CONSTRAINTS = str(BENCH / "google_excerpt_10k_constraints.csv.gz")
EXCERPT_MACHINES = str(BENCH / "google_excerpt_10k_machine_events.csv.gz")
DATA = Path(__file__).parent / "data"
G_EVENTS = str(DATA / "google_tiny_events.csv")
G_CONSTRAINTS = str(DATA / "google_tiny_constraints.csv")
A_VM = str(DATA / "azure_tiny_vm.csv")
A_VMTYPES = str(DATA / "azure_tiny_vmtypes.csv")
TINY = str(DATA / "tiny_trace.csv")
FLOAT_METRICS = ("makespan", "mean_response", "p99_response", "moved_units",
                 "moved_packets", "admitted_work")

# examples/trace_replay.py's cluster: 4 machine classes x 4 nodes
REPLAY_POWERS = (1.0,) * 4 + (1.25,) * 4 + (1.75,) * 4 + (2.0,) * 4
REPLAY_ATTRS = {"machine_class": (0.0,) * 4 + (1.0,) * 4 + (2.0,) * 4
                + (3.0,) * 4}


def _both_parse(fn_name, *args, **kwargs):
    """Run one parser in each package; both must warn the same warnings."""
    out = []
    for pkg in (jtraces, traces):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append(getattr(pkg, fn_name)(*args, **kwargs))
        out.append([(w.category, str(w.message)) for w in caught])
    want, want_warn, got, got_warn = out
    assert got_warn == want_warn
    return got, want


def _assert_schema_equal(got, want):
    assert type(got).__module__ == "repro_torch.traces.schema"
    assert type(want).__module__ == "repro.traces.schema"
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif dataclasses.is_dataclass(b):
            for g in dataclasses.fields(b):
                x, y = getattr(a, g.name), getattr(b, g.name)
                if isinstance(y, np.ndarray):
                    assert x.dtype == y.dtype, (f.name, g.name)
                    np.testing.assert_array_equal(x, y,
                                                  err_msg=f"{f.name}.{g.name}")
                else:
                    assert x == y, (f.name, g.name)
        else:
            assert a == b, f.name
    assert got.m == want.m
    assert got.n_tiers == want.n_tiers
    assert got.constrained == want.constrained
    assert got.preempted == want.preempted
    assert got.has_dag == want.has_dag
    assert got.tier_counts() == want.tier_counts()
    assert got.horizon == want.horizon


@pytest.fixture(scope="module")
def excerpts():
    """The bundled excerpt parsed by both packages in every way the lab
    reads it (the parse is ~0.1 s each)."""
    out = {}
    for key, params in {
            "end": {"eviction_mode": "end"},
            "requeue": {},
            "end+constraints": {"eviction_mode": "end",
                                "constraints_path": EXCERPT_CONSTRAINTS},
            "requeue+constraints": {"constraints_path":
                                    EXCERPT_CONSTRAINTS},
            "job_chains": {"eviction_mode": "end", "job_chains": True},
    }.items():
        out[key] = _both_parse("load_google_task_events", EXCERPT, **params)
    return out


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["end", "requeue", "end+constraints",
                                 "requeue+constraints", "job_chains"])
def test_google_excerpt_parses_as_the_reference(excerpts, key):
    got, want = excerpts[key]
    _assert_schema_equal(got, want)
    assert got.m == 10_000


def test_excerpt_sizes_are_the_documented_ones(excerpts):
    end, _ = excerpts["end"]
    assert end.n_tiers == 8 and not end.constrained and not end.has_dag
    assert int(end.ends_evicted.sum()) == 157
    con, _ = excerpts["requeue+constraints"]
    assert con.constraints.k == 3428 and con.preempted


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(constraints_path=G_CONSTRAINTS),
    dict(constraints_path=G_CONSTRAINTS, eviction_mode="end"),
    dict(eviction_mode="requeue", default_duration=3.0, packet_scale=8.0),
    dict(time_scale=1e-3, job_chains=True),
    dict(constraints_path=G_CONSTRAINTS, horizon=0.5),
], ids=["plain", "constraints", "end", "knobs", "clock-chains", "horizon"])
def test_google_tiny_parses_as_the_reference(kwargs):
    got, want = _both_parse("load_google_task_events", G_EVENTS, **kwargs)
    _assert_schema_equal(got, want)


def test_google_gzip_and_chunking_match(tmp_path):
    gz = tmp_path / "events.csv.gz"
    gz.write_bytes(gzip.compress(Path(G_EVENTS).read_bytes()))
    got, want = _both_parse("load_google_task_events", str(gz),
                            constraints_path=G_CONSTRAINTS, chunk_bytes=64)
    _assert_schema_equal(got, want)
    # gzip and 64-byte chunks change nothing against the plain file
    plain, _ = _both_parse("load_google_task_events", G_EVENTS,
                           constraints_path=G_CONSTRAINTS)
    for f in ("t_arrive", "works", "packets", "priority", "ends_evicted"):
        np.testing.assert_array_equal(getattr(got, f), getattr(plain, f))


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(vmtypes_path=A_VMTYPES),
    dict(vmtypes_path=A_VMTYPES, time_scale=1.0, packet_scale=2.0,
         default_duration=0.125),
], ids=["vm-only", "vmtypes", "knobs"])
def test_azure_tiny_parses_as_the_reference(kwargs):
    got, want = _both_parse("load_azure_packing", A_VM, **kwargs)
    _assert_schema_equal(got, want)


def test_azure_files_written_here_parse_as_the_reference(tmp_path):
    """A wider vm table with unknown priority codes, open-ended VMs and a
    vmType join, written to ``tmp_path``."""
    rng = np.random.default_rng(3)
    n = 300
    start = np.sort(rng.uniform(0.0, 5.0, n))
    end = start + rng.exponential(0.3, n)
    pri = rng.choice([0, 1, 2], n)
    vmt = rng.integers(0, 6, n)
    lines = ["# vmId,tenantId,vmTypeId,priority,starttime,endtime"]
    for i in range(n):
        e = "" if i % 17 == 0 else f"{end[i]:.6f}"
        lines.append(f"{i},{i % 9},{vmt[i]},{pri[i]},{start[i]:.6f},{e}")
    vm = tmp_path / "vm.csv.gz"
    vm.write_bytes(gzip.compress(("\n".join(lines) + "\n").encode()))
    types = tmp_path / "vmtypes.csv"
    types.write_text("\n".join(f"{t},{2 ** (t % 4)},{4 * (t + 1)}"
                               for t in range(5)) + "\n")
    got, want = _both_parse("load_azure_packing", str(vm),
                            vmtypes_path=str(types))
    _assert_schema_equal(got, want)
    assert got.constrained


def test_normalized_files_written_here_parse_as_the_reference(excerpts,
                                                              tmp_path):
    """Each package writes the constrained, requeue-mode excerpt (cut to
    its first 600 tasks) in the normalized format with its sidecar: the
    files are byte-identical and both packages read them back equal."""
    got, want = excerpts["requeue+constraints"]
    got, want = got.clipped(float(got.t_arrive[600])), \
        want.clipped(float(want.t_arrive[600]))
    paths = {}
    for name, pkg, tr in (("j", jtraces, want), ("t", traces, got)):
        csv, side = tmp_path / f"{name}.csv.gz", tmp_path / f"{name}.json"
        assert pkg.write_normalized_csv(tr, csv, constraints_path=side)
        paths[name] = (csv, side)
    (jcsv, jside), (csv, side) = paths["j"], paths["t"]
    assert gzip.decompress(csv.read_bytes()) == gzip.decompress(
        jcsv.read_bytes())
    assert side.read_bytes() == jside.read_bytes()
    back, jback = _both_parse("load_normalized_csv", str(csv),
                              constraints_path=str(side))
    _assert_schema_equal(back, jback)
    three, jthree = _both_parse("load_normalized_csv", TINY)
    _assert_schema_equal(three, jthree)


@pytest.mark.parametrize("text", [
    "1.0,2.0\n",
    "",
    "# only a comment\n",
])
def test_normalized_refusals_equal_reference(tmp_path, text):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    outcome = []
    for pkg in (jtraces, traces):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                outcome.append(("ok", pkg.load_normalized_csv(str(p)).m))
        except Exception as exc:  # noqa: BLE001 — compare what each raises
            outcome.append((type(exc).__name__, str(exc)))
    assert outcome[0] == outcome[1]


def test_machine_events_parse_as_the_reference(excerpts, tmp_path):
    tr, _ = excerpts["requeue"]
    for t_zero in (0.0, tr.t_zero_raw):
        got, want = _both_parse("load_google_machine_events",
                                EXCERPT_MACHINES, t_zero=t_zero)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_machines == 16
        assert got.failures and got.joins and got.resizes
    # the edge cases of tests/test_traces.py's machine_events section
    for i, text in enumerate([
            "0,0,0,,1.0,0.5\n0,1,0,,1.0,0.5\n1000000,1,1,,,\n"
            "2000000,1,0,,0.5,0.5\n3000000,0,2,,0.25,0.5\n",
            "0,0,0,,1.0,0.5\n5000000,3,0,,0.5,0.5\n6000000,4,0,,0,0\n",
            "0,0,0,,1.0,0.5\n1000000,0,2,,0.5,0.5\n2000000,0,1,,,\n"
            "3000000,0,0,,,\n",
            "0,0,0,,0,0\n1000000,0,2,,1.0,0.5\n",
            "0,0,1,,,\n0,0,0,,1.0,0.5\n",
            "7000000,2,1,,,\n7000000,2,0,,1.0,0.5\n"]):
        p = tmp_path / f"m{i}.csv"
        p.write_text(text)
        got, want = _both_parse("load_google_machine_events", str(p),
                                time_scale=1e-6)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), i


def test_load_trace_dispatch_equals_reference(excerpts):
    assert sorted(traces.TRACE_FORMATS) == sorted(jtraces.TRACE_FORMATS)
    assert traces.__all__ == jtraces.__all__
    got, want = _both_parse("load_trace", EXCERPT, format="google",
                            params={"eviction_mode": "end"}, scale=0.5,
                            seed=3, horizon=300.0)
    _assert_schema_equal(got, want)
    got, want = _both_parse("load_trace", A_VM, format="azure")
    _assert_schema_equal(got, want)
    for pkg in (jtraces, traces):
        with pytest.raises(ValueError, match="unknown trace format"):
            pkg.load_trace(TINY, format="parquet")


# ---------------------------------------------------------------------------
# schema helpers
# ---------------------------------------------------------------------------

HASH_VALUES = [0, 1, 2.5, -3, "7", "2.25", " 4 ", "P1", "platform-a",
               "vDSj8bAvmb+IqXXFzO4exDRbnlT6D7WwLSmb47oj8Ok=", "", True,
               1e300, "nan", "inf", "-0"]


def test_hash_attr_value_codes_equal_reference():
    for v in HASH_VALUES:
        got, want = traces.hash_attr_value(v), jtraces.hash_attr_value(v)
        assert (got == want) or (np.isnan(got) and np.isnan(want)), v
        assert type(got) is type(want)


@pytest.mark.parametrize("raw,hi", [
    ([9, 0, 0, 11, 2, 9], True),
    ([1, 0, 1, 1], False),
    ([5], True),
    ([], True),
])
def test_dense_tiers_equal_reference(raw, hi):
    got = traces.dense_tiers(np.asarray(raw), higher_is_more_important=hi)
    want = jtraces.dense_tiers(np.asarray(raw), higher_is_more_important=hi)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_feasibility_masks_and_diagnostics_equal_reference(excerpts):
    got, want = excerpts["requeue+constraints"]
    names = ("machine_class",)
    matrix = np.asarray(REPLAY_ATTRS["machine_class"])[:, None]
    np.testing.assert_array_equal(got.feasibility(names, matrix),
                                  want.feasibility(names, matrix))
    # a cluster with no class >= 2 node leaves the production tier nowhere
    low = np.zeros((4, 1))
    msgs = []
    for tr in (want, got):
        with pytest.raises(ValueError) as exc:
            tr.feasibility(names, low)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(traces.InfeasibleTaskError):
        got.feasibility(names, low)
    with pytest.raises(traces.InfeasibleTaskError) as exc:
        got.feasibility(("rack",), matrix)
    with pytest.raises(jtraces.InfeasibleTaskError) as jexc:
        want.feasibility(("rack",), matrix)
    assert str(exc.value) == str(jexc.value)
    for tid in range(0, got.m, 97):
        assert (got.constraints.describe_task(tid)
                == want.constraints.describe_task(tid))


def test_infeasible_task_error_is_the_engines():
    from repro_torch.runtime.runtime import InfeasibleTaskError
    assert traces.InfeasibleTaskError is InfeasibleTaskError
    from repro_torch.traces.schema import InfeasibleTaskError as schema_cls
    assert schema_cls is InfeasibleTaskError


# ---------------------------------------------------------------------------
# trace_scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["end", "requeue+constraints"])
@pytest.mark.parametrize("factor", [0.3, 1.0, 2.5, 17.0])
def test_trace_scale_equals_reference_per_seed(excerpts, key, factor):
    got, want = excerpts[key]
    for seed in (0, 1, 9):
        _assert_schema_equal(traces.trace_scale(got, factor, seed=seed),
                             jtraces.trace_scale(want, factor, seed=seed))


def test_trace_scale_windows_and_refusals_equal_reference(excerpts):
    got, want = excerpts["end"]
    _assert_schema_equal(traces.trace_scale(got, 3.0, seed=2, n_windows=7),
                         jtraces.trace_scale(want, 3.0, seed=2, n_windows=7))
    for args in ((0.0, {}), (-1.0, {}), (2.0, {"n_windows": 0})):
        msgs = []
        for pkg, tr in ((jtraces, want), (traces, got)):
            with pytest.raises(ValueError) as exc:
                pkg.trace_scale(tr, args[0], seed=0, **args[1])
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the lab: TraceRef scenarios
# ---------------------------------------------------------------------------

def _trace_scenario(pkg, *, policy="psts", mode="aware", horizon=60.0,
                    params=None, scale=None, machine_events=None, seed=0,
                    powers=REPLAY_POWERS, attrs=REPLAY_ATTRS):
    ref = pkg.TraceRef(
        path=EXCERPT, format="google",
        params={"constraints_path": EXCERPT_CONSTRAINTS}
        if params is None else params,
        scale=scale, machine_events=machine_events)
    return pkg.Scenario(
        name=f"trace/{policy}/{mode}",
        cluster=pkg.ClusterSpec(powers=powers, attrs=attrs,
                                bandwidth=256.0),
        workload=pkg.WorkloadSpec(trace=ref, horizon=horizon),
        policy=pkg.PolicySpec(policy, trigger_period=2.0,
                              params={"floor": 0.05}
                              if policy == "psts" else {},
                              constraint_mode=mode),
        seed=seed)


def _quiet_run(pkg, sc, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pkg.run(sc, **kw)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(scale=4.0, seed=3),
    dict(machine_events=EXCERPT_MACHINES),
    dict(params={"eviction_mode": "end"}, attrs=None),
    dict(params={"eviction_mode": "end", "time_scale": 1e-5}, scale=0.5),
], ids=["constrained", "scaled", "machine-events", "end", "params"])
def test_traceref_fingerprints_and_json_equal_reference(kw):
    jsc = _trace_scenario(jlab, **kw)
    sc = _trace_scenario(lab, **kw)
    assert sc.fingerprint() == jsc.fingerprint()
    assert sc.to_dict() == jsc.to_dict()
    assert lab.Scenario.from_json(jsc.to_json()).fingerprint() \
        == jsc.fingerprint()
    assert sc.workload.trace_files() == jsc.workload.trace_files()
    grid = {"seed": range(2), "workload.trace.scale": [2.0, 3.0]}
    assert ([s.fingerprint() for s in lab.expand_grid(sc, grid)]
            == [s.fingerprint() for s in jlab.expand_grid(jsc, grid)])


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.TraceRef(path=""),
    lambda pkg: pkg.TraceRef(path=EXCERPT, format="parquet"),
    lambda pkg: pkg.TraceRef(path=EXCERPT, format="google", scale=0.0),
    lambda pkg: pkg.TraceRef(path=EXCERPT, format="google",
                             params={"constraint_path": "x"}),
    lambda pkg: pkg.ClusterSpec(n_nodes=3, attrs={"rack": (0, 1)}),
    lambda pkg: pkg.WorkloadSpec(trace=pkg.TraceRef(path=TINY),
                                 trace_path=TINY),
], ids=["no-path", "format", "scale", "typo-param", "attr-count",
        "two-traces"])
def test_trace_spec_validation_equals_reference(make):
    with pytest.raises(ValueError) as want:
        make(jlab)
    with pytest.raises(ValueError) as got:
        make(lab)
    assert str(got.value) == str(want.value)


def test_attrs_codec_equals_reference():
    attrs = {"platform": ("P1", "P2", "P1", 3), "ssd": (0, 1, 1, 0)}
    got = lab.ClusterSpec(powers=(1.0, 2.0, 3.0, 4.0), attrs=attrs)
    want = jlab.ClusterSpec(powers=(1.0, 2.0, 3.0, 4.0), attrs=attrs)
    assert got.resolve_attrs() == want.resolve_attrs()
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("policy,mode", [("psts", "aware"),
                                         ("psts", "blind"),
                                         ("arrival_only", "blind"),
                                         ("jsq", "aware")])
def test_events_replay_of_the_excerpt_equals_reference(policy, mode):
    """The excerpt with its constraints table, requeue-mode evictions and
    machine events, cut by ``horizon`` to its first 150 s (~500 tasks)."""
    kw = dict(policy=policy, mode=mode, horizon=150.0,
              params={"constraints_path": EXCERPT_CONSTRAINTS,
                      "eviction_mode": "requeue"},
              machine_events=EXCERPT_MACHINES)
    jsc, sc = _trace_scenario(jlab, **kw), _trace_scenario(lab, **kw)
    got, want = _quiet_run(lab, sc), _quiet_run(jlab, jsc)
    assert got.to_dict() == want.to_dict()
    assert got.metrics.keys() == want.metrics.keys()
    for key in ("wait_by_tier", "tier_counts", "work_census"):
        assert got.extras[key] == want.extras[key], key
    assert got["completed"] == got["arrived"] > 0
    assert got["evictions"] > 0
    assert got["failures"] > 0 and got["joins"] > 0 and got["resizes"] > 0
    assert lab.resolve_fault_schedule(sc) == jlab.resolve_fault_schedule(jsc)


def test_end_mode_replay_carries_the_churn_census():
    kw = dict(params={"eviction_mode": "end"}, attrs=None, horizon=120.0)
    jsc, sc = _trace_scenario(jlab, **kw), _trace_scenario(lab, **kw)
    got, want = _quiet_run(lab, sc), _quiet_run(jlab, jsc)
    assert got.to_dict() == want.to_dict()
    assert "work_census" in got.extras and "tier_counts" in got.extras


@pytest.mark.parametrize("kw", [
    dict(),
    dict(params={"eviction_mode": "requeue"}, attrs=None),
    dict(params={"eviction_mode": "end"}, attrs=None),
    dict(params={"eviction_mode": "end"}, attrs=None, scale=3.0),
    dict(params={"eviction_mode": "end"}, attrs=None,
         machine_events=EXCERPT_MACHINES),
    dict(attrs=None),
    dict(attrs={"machine_class": (0.0,) * 16}),
    dict(params={"eviction_mode": "end"}, attrs=None, powers=(1.0,) * 8,
         machine_events=EXCERPT_MACHINES),
    dict(params={"eviction_mode": "end"}, attrs=None,
         machine_events="/nonexistent/machines.csv"),
], ids=["constrained", "requeue", "end", "scaled", "machine-events",
        "no-attrs", "infeasible", "too-few-nodes", "missing-machines"])
@pytest.mark.parametrize("backend", ["events", "batched", "legacy"])
def test_trace_eligibility_reasons_equal_reference(kw, backend):
    jsc, sc = _trace_scenario(jlab, **kw), _trace_scenario(lab, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jlab.get_backend(backend).eligible(jsc)
        assert lab.get_backend(backend).eligible(sc) == want


def _assert_batched_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.fingerprint == w.fingerprint
        assert g.backend == w.backend == "batched"
        assert g.backend_options == w.backend_options
        assert g.extras.keys() == w.extras.keys()
        for k, v in w.metrics.items():
            if k in FLOAT_METRICS and v is not None:
                np.testing.assert_allclose(g.metrics[k], v, rtol=1e-6,
                                           err_msg=k)
            else:
                assert g.metrics[k] == v, k


@pytest.mark.parametrize("fifo", [False, True])
def test_scaled_trace_sweep_on_batched_equals_reference(fifo):
    """A rate-scaled, unconstrained, end-mode trace: batched-eligible, its
    seed axis a real ensemble, priorities and eviction outcomes flagged as
    ignored, and the metrics equal to the JAX package's at rtol 1e-6."""
    kw = dict(params={"eviction_mode": "end"}, attrs=None, scale=0.8,
              horizon=200.0, powers=(1.0, 2.0, 3.0, 1.5, 2.5, 4.0, 1.0, 2.0))
    jsc, sc = _trace_scenario(jlab, **kw), _trace_scenario(lab, **kw)
    grid = {"seed": range(8)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = lab.sweep(base=sc, grid=grid, device="cpu", fifo_dispatch=fifo)
        want = jlab.sweep(base=jsc, grid=grid, fifo_dispatch=fifo)
    # a scaled trace's seeds differ: no seed-axis warning in either package
    assert not [w for w in caught if "seed axis" in str(w.message)]
    _assert_batched_match(got, want)
    assert got[0].backend_options["ignored"][-2:] == [
        "workload trace priorities",
        "workload trace eviction outcomes (ends_evicted)"]
    assert len({r["arrived"] for r in got}) > 1


def test_unscaled_trace_seed_axis_warns_as_the_reference():
    kw = dict(params={"eviction_mode": "end"}, attrs=None, horizon=30.0)
    for pkg in (jlab, lab):
        with pytest.warns(UserWarning, match="ignore the seed axis"):
            pkg.sweep(base=_trace_scenario(pkg, **kw),
                      grid={"seed": range(2)})


def test_scaled_trace_sweep_without_device_needs_the_gpu():
    """No fallback: a batched trace sweep with no ``device`` runs on the
    card, and without one it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    kw = dict(params={"eviction_mode": "end"}, attrs=None, scale=0.2,
              horizon=20.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        lab.sweep(base=_trace_scenario(lab, **kw), grid={"seed": range(8)})
