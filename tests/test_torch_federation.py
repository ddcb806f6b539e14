"""The port's federation layer (``repro_torch.federation`` and the lab's
``federated`` backend) held against the JAX package's ``repro.federation``
on the CPU.

The event-driven model (``FederatedRuntime``, async and lockstep) runs the
same numpy calls in the same order as the reference, so its aggregate,
per-member and WAN results are equal, as are spec fingerprints, balancer
decisions and eligibility reasons. The vectorized (link-free) model lowers
to the batched backend and is held at rtol 1e-6, with ``device="cpu"``.
The only values left out are the tracer's wall-clock decision latencies.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import json
import warnings

import jax
import jax.experimental

# jax >= 0.5 moved enable_x64 out of jax.experimental, where the JAX
# package's batched engine imports it from
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import federation as jfed  # noqa: E402
from repro import lab as jlab  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro_torch import federation as pfed  # noqa: E402
from repro_torch import lab  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402

# "replica" registers itself on first use in both packages; register it in
# both now, so the policy lists (and the reasons that name them) agree
jrt.make_policy("replica")
prt.make_policy("replica")

FLOAT_METRICS = ("makespan", "mean_response", "p99_response", "moved_units",
                 "moved_packets", "admitted_work")
# the tracer's wall-clock decision latencies, and the registry gauge that
# mirrors them: the only values that cannot equal the JAX package's
WALL_CLOCK = ("mean_us", "p99_us", "p999_us", "max_us")
LATENCY_GAUGE = "sched_decision_latency_us"


def _member(pkg, i, rate, *, n_nodes=4, horizon=40.0, obs=None, **kw):
    return pkg.Scenario(
        name=f"dc{i}",
        cluster=pkg.ClusterSpec(n_nodes=n_nodes, power_seed=i,
                                bandwidth=256.0),
        workload=pkg.WorkloadSpec(process="poisson", horizon=horizon,
                                  work_mean=6.0, params={"rate": rate}),
        policy=pkg.PolicySpec("psts", trigger_period=1.0,
                              params={"floor": 0.05}),
        obs=obs, seed=i, **kw)


def _geo(pkg, *, kind="full", mode="async", exchange="push", rates=None,
         n_nodes=8, horizon=40.0, obs=None, period=4.0):
    """``repro.lab.cli``'s geo-federation preset's shape, cut in horizon."""
    rates = rates or (12.0, 2.0, 2.0, 2.0)
    return pkg.Federation(
        name="geo-federation",
        members=tuple(_member(pkg, i, r, n_nodes=n_nodes, horizon=horizon,
                              obs=obs)
                      for i, r in enumerate(rates)),
        topology=pkg.TopologySpec(kind=kind, bandwidth=8.0, latency=2.0),
        exchange_period=period, mode=mode, exchange=exchange)


def _planet(pkg, *, mode="async", exchange="stealing"):
    """``repro.lab.cli``'s planet-federation preset's shape: two regional
    federations and a standalone cluster."""
    def region(j, rates):
        return pkg.Federation(
            name=f"region{j}",
            members=tuple(_member(pkg, 2 * j + i, r, horizon=30.0)
                          for i, r in enumerate(rates)),
            topology=pkg.TopologySpec(kind="full", bandwidth=16.0,
                                      latency=1.0),
            exchange_period=2.0, mode=mode)
    return pkg.Federation(
        name="planet-federation",
        members=(region(0, (10.0, 2.0)), region(1, (2.0, 2.0)),
                 _member(pkg, 4, 2.0, horizon=30.0)),
        topology=pkg.TopologySpec(kind="full", bandwidth=8.0, latency=2.0),
        exchange_period=4.0, exchange=exchange, mode=mode)


def _scrub(payload):
    """A JSON payload with the wall-clock latencies set to None wherever
    they appear (decision stats, the Chrome trace's otherData, the latency
    gauge of a registry snapshot)."""
    payload = json.loads(json.dumps(payload))

    def walk(node):
        if isinstance(node, dict):
            for k in list(node):
                if k in WALL_CLOCK:
                    node[k] = None
                elif k == LATENCY_GAUGE and isinstance(node[k], dict):
                    node[k]["samples"] = {s: None
                                          for s in node[k]["samples"]}
                else:
                    walk(node[k])
        elif isinstance(node, list):
            for x in node:
                walk(x)
    walk(payload)
    return payload


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda pkg: _geo(pkg),
    lambda pkg: _geo(pkg, kind="ring", mode="lockstep"),
    lambda pkg: _geo(pkg, kind="isolated"),
    lambda pkg: _planet(pkg),
    lambda pkg: pkg.Federation(
        members=(_member(pkg, 0, 3.0), _member(pkg, 1, 1.0)),
        topology=pkg.TopologySpec(kind="explicit", links=(
            pkg.LinkSpec(src=0, dst=1, bandwidth=4.0, latency=0.5),)),
        admission_margin=1.5),
], ids=["geo", "ring-lockstep", "isolated", "planet", "explicit"])
def test_spec_round_trips_and_fingerprints_equal_reference(make):
    want, got = make(jlab), make(lab)
    assert got.fingerprint() == want.fingerprint()
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()
    back = lab.Federation.from_json(want.to_json())
    assert back == got and back.fingerprint() == want.fingerprint()
    again = lab.Federation.from_dict(json.loads(got.to_json()))
    assert again.fingerprint() == want.fingerprint()
    assert hash(back) == hash(got)
    for path, value in (("exchange_period", 2.0),
                        ("members.1.workload.params.rate", 9.0),
                        ("members.2.seed", 5),
                        ("topology.bandwidth", 3.0)):
        outcome = []
        for fed in (want, got):
            try:
                outcome.append(fed.updated({path: value}).fingerprint())
            except (KeyError, IndexError) as exc:  # no such member
                outcome.append((type(exc).__name__, str(exc)))
        assert outcome[0] == outcome[1], path


def test_lab_reexports_the_federation_specs():
    assert lab.Federation is pfed.Federation
    assert lab.LinkSpec is pfed.LinkSpec
    assert lab.TopologySpec is pfed.TopologySpec
    assert pfed.__all__ == jfed.__all__
    for name in ("TOPOLOGY_KINDS", "FEDERATION_MODES", "EXCHANGE_POLICIES"):
        assert sorted(getattr(pfed, name)) == sorted(getattr(jfed, name))


@pytest.mark.parametrize("kind", ["isolated", "full", "ring", "star",
                                  "line"])
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_topology_resolution_equals_reference(kind, n):
    got = pfed.TopologySpec(kind=kind, bandwidth=3.0, latency=0.5).resolve(n)
    want = jfed.TopologySpec(kind=kind, bandwidth=3.0,
                             latency=0.5).resolve(n)
    assert [lk.to_dict() for lk in got] == [lk.to_dict() for lk in want]


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.Federation(members=()),
    lambda pkg: _geo(pkg, period=0.0),
    lambda pkg: _geo(pkg).replace(admission_margin=-1.0),
    lambda pkg: _geo(pkg, mode="sync"),
    lambda pkg: _geo(pkg, exchange="gossip"),
    lambda pkg: pkg.TopologySpec(kind="mesh"),
    lambda pkg: pkg.TopologySpec(kind="full", bandwidth=0.0),
    lambda pkg: pkg.LinkSpec(src=0, dst=0),
    lambda pkg: pkg.LinkSpec(src=0, dst=1, latency=-1.0),
    lambda pkg: pkg.TopologySpec(kind="explicit", links=(
        pkg.LinkSpec(src=0, dst=5),)).resolve(2),
    lambda pkg: _geo(pkg).updated({"members.9.seed": 1}),
    lambda pkg: _geo(pkg).updated({"nonsense": 1}),
], ids=["empty", "period", "margin", "mode", "exchange", "kind",
        "bandwidth", "self-link", "latency", "explicit-range",
        "member-index", "unknown-field"])
def test_spec_validation_equals_reference(make):
    outcome = []
    for pkg in (jlab, lab):
        try:
            make(pkg)
            outcome.append(None)
        except Exception as exc:  # noqa: BLE001 — compare what each raises
            outcome.append((type(exc).__name__, str(exc)))
    assert outcome[0] == outcome[1]
    assert outcome[0] is not None


# ---------------------------------------------------------------------------
# balancer
# ---------------------------------------------------------------------------

def test_balancer_functions_equal_reference():
    rng = np.random.default_rng(11)
    for _ in range(300):
        n = int(rng.integers(1, 7))
        loads = rng.exponential(40.0, n) * (rng.random(n) < 0.8)
        powers = rng.uniform(0.0, 12.0, n) * (rng.random(n) < 0.9)
        mask = rng.random(n) < 0.6
        work = float(rng.uniform(0.1, 20.0))
        assert (pfed.choose_destination(loads, powers, mask, work)
                == jfed.choose_destination(loads, powers, mask, work))
        args = (float(loads[0]), float(powers[0]), float(loads[-1]),
                float(powers[-1]))
        kw = dict(work=work, delay=float(rng.uniform(0, 10)),
                  margin=float(rng.choice([0.0, 1.0, 5.0])))
        assert pfed.admit(*args, **kw) == jfed.admit(*args, **kw)
        assert (pfed.choose_victim(loads, powers, mask)
                == jfed.choose_victim(loads, powers, mask))
    a, b = pfed.ExchangeStats(), jfed.ExchangeStats()
    assert a.to_dict() == b.to_dict()


# ---------------------------------------------------------------------------
# the event-driven model
# ---------------------------------------------------------------------------

def _run_both(make, **kw):
    want = jlab.run(make(jlab), backend="federated", **kw)
    got = lab.run(make(lab), backend="federated", **kw)
    return got, want


@pytest.mark.parametrize("make", [
    lambda pkg: _geo(pkg),
    lambda pkg: _geo(pkg, mode="lockstep"),
    lambda pkg: _geo(pkg, exchange="stealing"),
    lambda pkg: _geo(pkg, kind="ring", mode="lockstep",
                     exchange="stealing"),
    lambda pkg: _geo(pkg, kind="star", rates=(2.0, 2.0, 12.0, 2.0)),
    lambda pkg: _planet(pkg),
    lambda pkg: _planet(pkg, mode="lockstep", exchange="push"),
], ids=["geo-async", "geo-lockstep", "geo-stealing", "ring-lockstep-steal",
        "star", "planet-async", "planet-lockstep"])
def test_federated_runtime_equals_reference(make):
    got, want = _run_both(make)
    assert got.to_dict() == want.to_dict()
    assert got.extras["members"] == want.extras["members"]
    assert got.extras["wan"] == want.extras["wan"]
    assert got["completed"] == got["arrived"]


def test_geo_federation_beats_isolated_as_in_the_reference():
    fed, iso = _run_both(lambda pkg: _geo(pkg))[0], _run_both(
        lambda pkg: _geo(pkg, kind="isolated"), vectorize=False)
    assert iso[0].to_dict() == iso[1].to_dict()
    assert iso[0].backend_options["model"] == "async-events"
    assert fed.extras["wan"]["migrations"] > 0
    assert fed["mean_response"] < iso[0]["mean_response"]


def test_member_faults_and_traces_run_as_in_the_reference(tmp_path):
    csv = tmp_path / "hot.csv"
    rng = np.random.default_rng(2)
    csv.write_text("".join(f"{t:.6f},{w:.6f},2.0\n" for t, w in zip(
        np.sort(rng.uniform(0, 20, 80)), rng.uniform(0.5, 4.0, 80))))

    def make(pkg):
        fed = _geo(pkg, rates=(6.0, 1.0, 1.0))
        hot = fed.members[0].replace(
            workload=pkg.WorkloadSpec(trace_path=str(csv), horizon=None),
            faults=pkg.FaultSpec(failures=((5.0, 1), (6.0, 2)),
                                 joins=((25.0, 1),)))
        return fed.replace(members=(hot,) + fed.members[1:])
    got, want = _run_both(make)
    assert got.to_dict() == want.to_dict()


def test_runtime_session_verbs_equal_reference():
    out = []
    for pkg, fedpkg in ((jlab, jfed), (lab, pfed)):
        frt = fedpkg.FederatedRuntime(_geo(pkg))
        n = frt.advance(until=5.3)
        mid = frt.census() if hasattr(frt, "census") else None
        report = frt.drain()
        out.append((n, mid, report.aggregate.summary(),
                    [m.summary() for m in report.members],
                    report.wan.to_dict(), report.epochs,
                    frt.work_census(1e9)))
    assert out[0] == out[1]
    agg = pfed.aggregate_metrics
    assert agg is not None


def test_federation_obs_equals_reference():
    """Traced and metered members: the stitched Chrome trace, the WAN
    stream, the merged registry and its scrape, as in the JAX package."""
    def make(pkg):
        return _geo(pkg, rates=(8.0, 1.0, 1.0), exchange="stealing",
                    obs=pkg.ObsSpec(trace=True, probe_every=2.0,
                                    metrics=True))
    got, want = _run_both(make)
    assert _scrub(got.to_dict()) == _scrub(want.to_dict())
    assert "stitched_trace" in got.extras["obs"]
    frts = []
    for pkg, fedpkg in ((jlab, jfed), (lab, pfed)):
        frt = fedpkg.FederatedRuntime(make(pkg))
        frt.run()
        frts.append(frt)
    jfrt, frt = frts
    assert _scrub(frt.registry().snapshot()) == _scrub(
        jfrt.registry().snapshot())
    lines = [[ln for ln in f.scrape().splitlines()
              if not ln.startswith(LATENCY_GAUGE + "{")] for f in frts]
    assert lines[0] == lines[1]
    assert _scrub(frt.stitched_trace()) == _scrub(jfrt.stitched_trace())


# ---------------------------------------------------------------------------
# the vectorized (link-free) model
# ---------------------------------------------------------------------------

def _isolated(pkg, n=8, **kw):
    return pkg.Federation(
        name="iso",
        members=tuple(pkg.Scenario(
            name=f"m{i}",
            cluster=pkg.ClusterSpec(n_nodes=16, power_seed=0),
            workload=pkg.WorkloadSpec(process="poisson", horizon=30.0,
                                      work_mean=6.0, params={"rate": 8.0}),
            policy=pkg.PolicySpec("psts", params={"floor": 0.1}),
            seed=i, **kw) for i in range(n)),
        topology=pkg.TopologySpec(kind="isolated"))


def _assert_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in FLOAT_METRICS and v is not None:
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("n", [1, 3, 8])
def test_vectorized_federation_equals_reference(n):
    want = jlab.run(_isolated(jlab, n), backend="federated")
    got = lab.run(_isolated(lab, n), backend="federated", device="cpu")
    assert got.backend == want.backend == "federated"
    assert got.backend_options == want.backend_options
    assert got.backend_options["model"] == "fluid-batched"
    assert got.fingerprint == want.fingerprint
    _assert_close(got.metrics, want.metrics)
    assert got.extras.keys() == want.extras.keys()
    assert got.extras["wan"] == want.extras["wan"]
    for g, w in zip(got.extras["members"], want.extras["members"]):
        assert g["fingerprint"] == w["fingerprint"]
        assert g["backend_options"] == w["backend_options"]
        _assert_close(g["metrics"], w["metrics"])
    assert got["arrived"] == sum(m["metrics"]["arrived"]
                                 for m in got.extras["members"])


def test_vectorized_members_equal_a_batched_sweep():
    fed = _isolated(lab)
    got = lab.run(fed, backend="federated", device="cpu")
    sweep = lab.sweep(list(fed.members), backend="batched", device="cpu")
    assert [m for m in got.extras["members"]] == [r.to_dict()
                                                  for r in sweep]


def test_vectorize_flag_is_validated_as_in_the_reference():
    for pkg in (jlab, lab):
        with pytest.raises(pkg.BackendError, match="has WAN links"):
            pkg.run(_geo(pkg), backend="federated", vectorize=True)
        with pytest.raises(pkg.BackendError, match="nested federation"):
            pkg.run(_planet(pkg).replace(
                topology=pkg.TopologySpec(kind="isolated")),
                backend="federated", vectorize=True)
    with pytest.raises(TypeError, match="vectorize and device only"):
        lab.run(_geo(lab), backend="federated", nonsense=1)
    # a forced event run of a link-free federation equals the reference
    got, want = _run_both(lambda pkg: _isolated(pkg, 3), vectorize=False)
    assert got.to_dict() == want.to_dict()
    # the event path is host code and ignores the device
    assert lab.run(_isolated(lab, 3), backend="federated", vectorize=False,
                   device="cuda:7").to_dict() == got.to_dict()


def test_vectorized_federation_without_device_needs_the_gpu():
    """No fallback: a link-free federation's vectorized run goes to the
    card, and without one it raises instead of carrying on on the CPU.
    ``lab.run`` defaults to the events backend, as in the JAX package,
    which routes a federation to the federated backend by its reason."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        lab.run(_isolated(lab, 2), backend="federated")
    with pytest.raises(RuntimeError, match="CUDA"):
        lab.sweep([_isolated(lab, 2)])
    for pkg in (jlab, lab):
        with pytest.raises(pkg.BackendError, match="'federated' backend"):
            pkg.run(_isolated(pkg, 2))


# ---------------------------------------------------------------------------
# eligibility and lab.sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda pkg: _geo(pkg),
    lambda pkg: _geo(pkg).members[0],
    lambda pkg: _geo(pkg).updated({"members.1.policy.name": "nonsense"}),
    lambda pkg: _geo(pkg).updated(
        {"members.2.faults.failures": ((3.0, 99),)}),
    lambda pkg: _geo(pkg).replace(topology=pkg.TopologySpec(
        kind="explicit", links=(pkg.LinkSpec(src=0, dst=5),))),
    lambda pkg: _planet(pkg).updated(
        {"members.0.members.1.policy.name": "nonsense"}),
    lambda pkg: _isolated(pkg, 2),
], ids=["ok", "single-scenario", "bad-member", "fault-range", "links",
        "nested-member", "isolated"])
@pytest.mark.parametrize("backend", ["federated", "events", "batched",
                                     "legacy"])
def test_eligibility_reasons_equal_reference(make, backend):
    want = jlab.get_backend(backend).eligible(make(jlab))
    assert lab.get_backend(backend).eligible(make(lab)) == want


def test_sweep_dispatches_federations_as_in_the_reference():
    feds = [_geo(lab, rates=(r, 1.0)) for r in (6.0, 3.0)]
    jfeds = [_geo(jlab, rates=(r, 1.0)) for r in (6.0, 3.0)]
    for pkg, specs in ((lab, feds), (jlab, jfeds)):
        with pytest.warns(UserWarning, match="'dt' option is ignored"):
            pkg.sweep(specs[:1], dt=0.5)
    got = lab.sweep(feds, device="cpu")
    want = jlab.sweep(jfeds)
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert {r.backend for r in got} == {"federated"}
    # device reaches the vectorized path of a link-free federation
    iso = lab.sweep([_isolated(lab, 2)], device="cpu")
    assert iso[0].backend_options["model"] == "fluid-batched"
    with pytest.raises(lab.BackendError, match="runs Federation specs"):
        lab.sweep([feds[0].members[0]], backend="federated")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lab.sweep(feds[:1], device="cpu")
