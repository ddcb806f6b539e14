"""Command-line front end: scenarios as JSON files.

::

    python -m repro_torch.lab template [--preset bursty-failover] > sc.json
    python -m repro_torch.lab run sc.json --backend events --out result.json
    python -m repro_torch.lab sweep sc.json --grid seed=0:64 --backend auto
    python -m repro_torch.lab backends sc.json      # eligibility report
    python -m repro_torch.lab serve sc.json --feed tasks.jsonl  # online
    python -m repro_torch.lab trace events.csv.gz --format google \
        --param constraints_path=constr.csv         # inspect / convert

Grid axes are ``path=values`` with dotted scenario paths: ``seed=0:64``
(range), ``seed=0:64:4`` (strided), ``policy.name=jsq,psts`` (list),
``policy.params.floor=0.05,0.1`` (floats). Repeat ``--grid`` for a product.

Arguments, messages and JSON output are those of the JAX package's
``python -m repro.lab``. The port adds ``--device`` to ``run`` and
``sweep``: where the batched backend (and the federated backend's
vectorized path) runs, the CUDA device unless it says otherwise
(``--device cpu`` runs the kernels' plain PyTorch versions). With no GPU
and no ``--device`` such a run raises; it never carries on on the CPU. The
host backends (``events``, ``legacy``, ``online``) take no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..federation import Federation, TopologySpec
from ..serve import backend as _serve_backend  # noqa: F401 — registers "online"
from .api import BATCH_THRESHOLD, expand_grid, run, sweep
from .backends import BACKENDS
from .specs import (
    ClusterSpec,
    FaultSpec,
    ObsSpec,
    PolicySpec,
    Scenario,
    WorkloadSpec,
)

__all__ = ["main", "PRESETS"]

# the backends that take a device: the batched engine, and the federated
# backend's vectorized path (its event path ignores it)
DEVICE_BACKENDS = ("batched", "federated")


def _preset_basic() -> Scenario:
    return Scenario(
        name="basic-psts",
        cluster=ClusterSpec(n_nodes=16, d=None, bandwidth=256.0),
        workload=WorkloadSpec(process="poisson", horizon=200.0,
                              work_mean=6.0, params={"rate": 8.0}),
        policy=PolicySpec(name="psts", trigger_period=1.0,
                          params={"floor": 0.05}),
    )


def _preset_bursty_failover() -> Scenario:
    return Scenario(
        name="bursty-failover",
        cluster=ClusterSpec(n_nodes=16, d=None, bandwidth=256.0),
        workload=WorkloadSpec(
            process="bursty", horizon=200.0, work_mean=6.0,
            params={"rate_lo": 0.5, "rate_hi": 18.0,
                    "sojourn_lo": 25.0, "sojourn_hi": 6.0}),
        policy=PolicySpec(name="psts", trigger_period=1.0,
                          params={"floor": 0.05}),
        faults=FaultSpec(failures=((40.0, 2),), joins=((120.0, 2),)),
    )


def _preset_paper_static() -> Scenario:
    return Scenario(
        name="paper-static",
        cluster=ClusterSpec(n_nodes=16, d=1),
        workload=WorkloadSpec(process="poisson", horizon=100.0,
                              work_dist="uniform", work_mean=2.0,
                              m_tasks=4000),
        policy=PolicySpec(name="psts"),
    )


def _preset_geo_federation() -> Federation:
    """Four geo-distributed clusters, one overloaded: the shape WAN work
    exchange exists for."""
    rates = [12.0, 2.0, 2.0, 2.0]
    members = tuple(
        Scenario(
            name=f"dc{i}",
            cluster=ClusterSpec(n_nodes=8, power_seed=i, bandwidth=256.0),
            workload=WorkloadSpec(process="poisson", horizon=100.0,
                                  work_mean=6.0, params={"rate": rate}),
            policy=PolicySpec(name="psts", trigger_period=1.0,
                              params={"floor": 0.05}),
            seed=i)
        for i, rate in enumerate(rates))
    return Federation(
        name="geo-federation",
        members=members,
        topology=TopologySpec(kind="full", bandwidth=8.0, latency=2.0),
        exchange_period=4.0)


def _preset_planet_federation() -> Federation:
    """Hierarchy (the paper's recursion at level k+2): two regional
    federations of two clusters each plus a standalone cluster, stealing
    work asynchronously over the inter-region WAN."""
    def dc(i: int, rate: float) -> Scenario:
        return Scenario(
            name=f"dc{i}",
            cluster=ClusterSpec(n_nodes=4, power_seed=i, bandwidth=256.0),
            workload=WorkloadSpec(process="poisson", horizon=60.0,
                                  work_mean=6.0, params={"rate": rate}),
            policy=PolicySpec(name="psts", trigger_period=1.0,
                              params={"floor": 0.05}),
            seed=i)

    def region(j: int, rates) -> Federation:
        return Federation(
            name=f"region{j}",
            members=tuple(dc(2 * j + i, r) for i, r in enumerate(rates)),
            topology=TopologySpec(kind="full", bandwidth=16.0, latency=1.0),
            exchange_period=2.0)

    return Federation(
        name="planet-federation",
        members=(region(0, (10.0, 2.0)), region(1, (2.0, 2.0)),
                 dc(4, 2.0)),
        topology=TopologySpec(kind="full", bandwidth=8.0, latency=2.0),
        exchange_period=4.0, exchange="stealing")


PRESETS = {
    "basic": _preset_basic,
    "bursty-failover": _preset_bursty_failover,
    "paper-static": _preset_paper_static,
    "geo-federation": _preset_geo_federation,
    "planet-federation": _preset_planet_federation,
}


def _parse_value(tok: str):
    for conv in (int, float):
        try:
            return conv(tok)
        except ValueError:
            pass
    return tok


def _parse_grid(specs: list[str]) -> dict:
    grid: dict = {}
    for item in specs:
        if "=" not in item:
            raise SystemExit(f"--grid {item!r}: expected path=values")
        path, values = item.split("=", 1)
        if ":" in values:
            parts = values.split(":")
            if len(parts) not in (2, 3) or not all(
                    p.lstrip("-").isdigit() for p in parts):
                raise SystemExit(
                    f"--grid {item!r}: ranges are integer start:stop[:step]"
                    f"; use a comma list for floats (e.g. "
                    f"{path}=0.05,0.1)")
            grid[path] = list(range(*map(int, parts)))
        else:
            grid[path] = [_parse_value(v) for v in values.split(",")]
    return grid


def _load_scenario(path: str) -> Scenario | Federation:
    """A spec file with a ``members`` section is a Federation; anything
    else is a single-cluster Scenario."""
    d = json.loads(Path(path).read_text())
    if "members" in d:
        return Federation.from_dict(d)
    return Scenario.from_dict(d)


def _emit(results, out: str | None) -> None:
    payload = [r.to_dict() for r in results]  # to_dict is NaN-safe
    text = json.dumps(payload, indent=2, sort_keys=True, allow_nan=False)
    if out:
        Path(out).write_text(text + "\n")
        _table(results)
        print(f"wrote {len(results)} result(s) to {out}")
    else:
        print(text)


def _table(results) -> None:
    cols = ("mean_response", "p99_response", "makespan", "trigger_fires")
    print(f"{'backend':<9} {'fingerprint':<17} "
          + " ".join(f"{c:>14}" for c in cols))
    for r in results:
        cells = []
        for c in cols:
            v = r.metrics[c]
            cells.append(f"{'-':>14}" if v is None else f"{v:>14.3f}")
        print(f"{r.backend:<9} {r.fingerprint:<17} " + " ".join(cells))


def _trace_cmd(args) -> int:
    from ..traces import (
        load_google_machine_events,
        load_trace,
        write_normalized_csv,
    )
    params = {}
    for item in args.param:
        if "=" not in item:
            raise SystemExit(f"--param {item!r}: expected K=V")
        k, v = item.split("=", 1)
        params[k] = _parse_value(v)
    if args.eviction_mode is not None:
        if args.format != "google":
            raise SystemExit("--eviction-mode applies to --format google "
                             "(EVICT/KILL/FAIL rows); other formats carry "
                             "no eviction events")
        params["eviction_mode"] = args.eviction_mode
    trace = load_trace(args.path, format=args.format, params=params,
                       scale=args.scale, seed=args.seed)
    span = trace.horizon - (float(trace.t_arrive[0]) if trace.m else 0.0)
    print(f"tasks        {trace.m}")
    print(f"span         {span:.3f} time units")
    print(f"total work   {float(trace.works.sum()):.3f}")
    print(f"mean packets {float(trace.packets.mean()) if trace.m else 0:.3f}")
    tiers = trace.tier_counts()
    print(f"tiers        {len(tiers)}"
          + "".join(f"\n  tier {t:<3} {c} task(s)"
                    for t, c in tiers.items()))
    c = trace.constraints
    print(f"constraints  {c.k} row(s)"
          + (f" over attrs {sorted(c.attr_names)}" if c.k else ""))
    print(f"evictions    {trace.evictions.k} requeue event(s), "
          f"{int(trace.ends_evicted.sum())} task(s) end evicted")
    if args.deps:
        dag = trace.dag
        if dag.empty:
            print("deps         none (no dependency edges in this trace)")
        else:
            print(f"deps         {dag.k} edge(s) over {dag.m} task(s)")
            print(f"  depth          {dag.depth()} level(s)")
            print(f"  width          {dag.width()} task(s)")
            print(f"  critical path  {dag.critical_path():.0f} task(s) "
                  f"(unit works); "
                  f"{dag.critical_path(trace.works):.3f} work units")
    if args.machine_events:
        # same clock defaults as TraceRef.load_machine_events: google
        # stamps microseconds, other formats are in plain time units —
        # the preview must match the schedule a run would actually use
        default_ts = 1e-6 if args.format == "google" else 1.0
        sched = load_google_machine_events(
            args.machine_events,
            time_scale=float(params.get("time_scale", default_ts)),
            t_zero=trace.t_zero_raw)
        print(f"machines     {sched.n_machines}: "
              f"{len(sched.failures)} failure(s), "
              f"{len(sched.joins)} join(s), "
              f"{len(sched.resizes)} resize(s)")
    if args.out:
        wrote_sidecar = write_normalized_csv(
            trace, args.out, constraints_path=args.out_constraints)
        print(f"wrote normalized trace to {args.out}"
              + (f" (+ {args.out_constraints})" if wrote_sidecar else ""))
    return 0


def _serve_cmd(args, scenario) -> int:
    """Run a scenario as an online scheduling service: decisions stream
    out as JSONL while tasks stream in (scenario workload and/or a JSONL
    feed), the final metrics land on stderr / ``--out``."""
    from ..obs import MetricsHTTPServer, attach_collector, write_metrics_jsonl
    from ..serve import DecisionLog, JsonlSource, SchedulerService
    if getattr(scenario, "is_federation", False):
        raise SystemExit("serve drives a single Scenario; run a Federation "
                         "on the federated backend")
    if args.metrics_every is not None and args.metrics_every <= 0:
        raise SystemExit(f"--metrics-every must be > 0, "
                         f"got {args.metrics_every}")
    metrics_every = args.metrics_every
    if args.metrics_out and metrics_every is None:
        metrics_every = 5.0
    sink = (open(args.decisions_out, "w") if args.decisions_out
            else sys.stdout)
    metrics_fh = open(args.metrics_out, "w") if args.metrics_out else None
    server = None
    try:
        log = DecisionLog(
            keep=False,
            on_decision=lambda d: print(json.dumps(d.to_dict()), file=sink))
        svc = SchedulerService.from_scenario(
            scenario, attach_workload=not args.no_workload, log=log)
        if args.feed:
            svc.attach(JsonlSource(args.feed))
        if args.metrics_port is not None:
            server = MetricsHTTPServer(svc.scrape, port=args.metrics_port)
            print(f"metrics endpoint: {server.url}", file=sys.stderr)
        if args.step is not None and args.step <= 0:
            raise SystemExit(f"--step must be > 0, got {args.step}")
        # pace micro-steps on the finer of --step and --metrics-every so
        # the JSONL stream samples on its cadence even without --step
        pace = args.step
        if metrics_every is not None:
            pace = metrics_every if pace is None else min(pace,
                                                          metrics_every)
        collector = attach_collector(svc.rt) if metrics_fh else None
        next_mx = metrics_every if metrics_every is not None else None
        if pace is not None:
            while svc.session.pending_sources:
                svc.advance(until=svc.now + pace)
                if metrics_fh is not None and svc.now >= next_mx:
                    collector.refresh()
                    write_metrics_jsonl(metrics_fh, svc.now,
                                        collector.registry)
                    next_mx += metrics_every
        svc.drain()
        if metrics_fh is not None:
            # final sample: the drained end state
            collector.refresh()
            write_metrics_jsonl(metrics_fh, svc.now, collector.registry)
        svc.close()
    finally:
        if server is not None:
            server.close()
        if metrics_fh is not None:
            metrics_fh.close()
        if sink is not sys.stdout:
            sink.close()
    summary = svc.summary()
    payload = {"scenario": getattr(scenario, "name", None),
               "metrics": summary, "decisions": dict(log.counts)}
    if args.out:
        Path(args.out).write_text(
            json.dumps(payload, indent=2, sort_keys=True, allow_nan=False)
            + "\n")
    print(f"served {summary['completed']} task(s): "
          f"makespan={summary['makespan']:.3f} "
          f"mean_response={summary['mean_response']:.3f} "
          f"decisions={sum(log.counts.values())}", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lab",
        description="declarative scheduling experiments over one of three "
                    "backends")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_tpl = sub.add_parser("template", help="print a scenario JSON to edit")
    p_tpl.add_argument("--preset", choices=sorted(PRESETS), default="basic")

    p_run = sub.add_parser("run", help="run one scenario/federation file")
    p_run.add_argument("scenario")
    p_run.add_argument("--backend", default=None, choices=sorted(BACKENDS),
                       help="default: events for a Scenario, federated for "
                            "a Federation")
    p_run.add_argument("--dt", type=float, default=None,
                       help="slot width (batched backend only)")
    p_run.add_argument("--out", default=None, help="write result JSON here")
    p_run.add_argument("--device", default=None,
                       help="where the batched/federated backends run "
                            "(default: the CUDA device; 'cpu' runs the "
                            "plain PyTorch versions)")
    p_run.add_argument("--trace-out", default=None, metavar="FILE",
                       help="record a task-lifecycle trace and write it "
                            "here as Chrome-trace JSON (load in "
                            "chrome://tracing or Perfetto; events backend)")
    p_run.add_argument("--probe-every", type=float, default=None,
                       metavar="SECONDS",
                       help="sample occupancy/queue-depth/imbalance "
                            "time-series on this cadence (sim time units)")

    p_sweep = sub.add_parser("sweep", help="run a grid over a base scenario")
    p_sweep.add_argument("scenario")
    p_sweep.add_argument("--grid", action="append", default=[],
                         metavar="PATH=VALUES")
    p_sweep.add_argument("--backend", default="auto",
                         choices=["auto", *sorted(BACKENDS)])
    p_sweep.add_argument("--batch-threshold", type=int,
                         default=BATCH_THRESHOLD)
    p_sweep.add_argument("--dt", type=float, default=None)
    p_sweep.add_argument("--out", default=None)
    p_sweep.add_argument("--device", default=None,
                         help="where a batched sweep runs (default: the "
                              "CUDA device; 'cpu' runs the plain PyTorch "
                              "versions); host backends ignore it")

    p_back = sub.add_parser("backends",
                            help="eligibility report for a scenario file")
    p_back.add_argument("scenario")

    p_srv = sub.add_parser(
        "serve", help="run a scenario as an online scheduling service: "
                      "stream decisions out as JSONL while tasks stream in")
    p_srv.add_argument("scenario")
    p_srv.add_argument("--feed", default=None, metavar="FILE",
                       help="JSONL task feed ('-' = stdin), one task per "
                            "line, e.g. {\"t\": 0.5, \"work\": 2.0, "
                            "\"packets\": 3}; streams on top of the "
                            "scenario's own workload")
    p_srv.add_argument("--no-workload", action="store_true",
                       help="ignore the scenario's workload; schedule only "
                            "the --feed tasks")
    p_srv.add_argument("--step", type=float, default=None,
                       help="fixed micro-step width in sim time units "
                            "(default: pace on arrival times)")
    p_srv.add_argument("--decisions-out", default=None, metavar="FILE",
                       help="write the decision JSONL here instead of "
                            "stdout")
    p_srv.add_argument("--out", default=None,
                       help="write final metrics + decision counts JSON "
                            "here")
    p_srv.add_argument("--metrics-out", default=None, metavar="FILE",
                       help="stream registry snapshots here as JSONL, one "
                            "record per --metrics-every of sim time")
    p_srv.add_argument("--metrics-every", type=float, default=None,
                       metavar="SECONDS",
                       help="metrics stream cadence in sim time units "
                            "(default 5.0 when --metrics-out is set)")
    p_srv.add_argument("--metrics-port", type=int, default=None,
                       metavar="PORT",
                       help="serve a live Prometheus/OpenMetrics scrape "
                            "endpoint on this port while the service runs "
                            "(0 picks a free port; URL prints on stderr)")

    from ..traces import TRACE_FORMATS
    p_tr = sub.add_parser(
        "trace", help="inspect a real trace file (and optionally convert "
                      "it to the normalized CSV format)")
    p_tr.add_argument("path")
    p_tr.add_argument("--format", default="csv",
                      choices=sorted(TRACE_FORMATS))
    p_tr.add_argument("--param", action="append", default=[],
                      metavar="K=V", help="parser kwarg, e.g. "
                      "constraints_path=FILE or time_scale=1e-6")
    from ..traces import EVICTION_MODES
    p_tr.add_argument("--eviction-mode", default=None,
                      choices=sorted(EVICTION_MODES),
                      help="google format: replay EVICT/KILL/FAIL rows as "
                      "requeue events ('requeue', default) or let them end "
                      "the service interval ('end', the pre-eviction-replay "
                      "behavior)")
    p_tr.add_argument("--machine-events", default=None, metavar="FILE",
                      help="google machine_events companion: print its "
                      "capacity churn as a failure/join/resize schedule")
    p_tr.add_argument("--deps", action="store_true",
                      help="print DAG stats (edges, depth, width, "
                      "critical-path length) when the trace carries "
                      "dependency edges — a deps sidecar or google "
                      "job_chains=true")
    p_tr.add_argument("--scale", type=float, default=None,
                      help="bootstrap an Nx-rate resample (trace_scale)")
    p_tr.add_argument("--seed", type=int, default=0,
                      help="resample seed (only with --scale)")
    p_tr.add_argument("--out", default=None,
                      help="write the normalized 4-column CSV here")
    p_tr.add_argument("--out-constraints", default=None,
                      help="write the constraints JSON sidecar here")

    args = parser.parse_args(argv)

    if args.cmd == "trace":
        return _trace_cmd(args)

    if args.cmd == "template":
        print(PRESETS[args.preset]().to_json())
        return 0

    scenario = _load_scenario(args.scenario)

    if args.cmd == "serve":
        return _serve_cmd(args, scenario)

    if args.cmd == "backends":
        for name in sorted(BACKENDS):
            reason = BACKENDS[name].eligible(scenario)
            status = "eligible" if reason is None else f"NOT eligible: {reason}"
            print(f"{name:<9} {status}")
        return 0

    if args.cmd == "run":
        if args.backend is None:
            args.backend = ("federated"
                            if getattr(scenario, "is_federation", False)
                            else "events")
        if args.dt is not None and args.backend != "batched":
            raise SystemExit(f"--dt sets the batched backend's slot width; "
                             f"it does nothing on {args.backend!r}")
        if args.device is not None and args.backend not in DEVICE_BACKENDS:
            raise SystemExit(f"--device picks where the batched and "
                             f"federated backends run; {args.backend!r} is "
                             f"host code")
        if args.trace_out or args.probe_every is not None:
            if getattr(scenario, "is_federation", False):
                raise SystemExit(
                    "--trace-out/--probe-every instrument a single "
                    "Scenario; for a Federation set an \"obs\" section on "
                    "the member(s) to instrument in the spec file")
            scenario = scenario.replace(obs=ObsSpec(
                trace=args.trace_out is not None,
                probe_every=args.probe_every))
        opts = {"dt": args.dt} if args.dt is not None else {}
        if args.backend in DEVICE_BACKENDS:
            opts["device"] = args.device
        result = run(scenario, backend=args.backend, **opts)
        if args.trace_out:
            obs = result.extras.get("obs") or {}
            trace = obs.pop("chrome_trace", None)
            if trace is None:
                raise SystemExit(
                    f"--trace-out: the {args.backend!r} backend records no "
                    f"per-task trace (see backend_options['ignored']); run "
                    f"on the events backend")
            Path(args.trace_out).write_text(
                json.dumps(trace, allow_nan=False) + "\n")
            print(f"wrote {trace['otherData']['n_events']} trace event(s) "
                  f"to {args.trace_out}")
        elif isinstance(result.extras.get("obs"), dict):
            # keep stdout/--out payloads readable: the full event list is
            # only emitted when a --trace-out destination asks for it
            result.extras["obs"].pop("chrome_trace", None)
        _emit([result], args.out)
        return 0

    # sweep
    grid = _parse_grid(args.grid)
    scenarios = expand_grid(scenario, grid)
    opts = {}
    if args.dt is not None:
        if args.backend not in ("auto", "batched"):
            raise SystemExit(f"--dt sets the batched backend's slot width; "
                             f"it does nothing on {args.backend!r}")
        opts["dt"] = args.dt
    # sweep hands device to the batched (or federated) backend alone
    results = sweep(scenarios, backend=args.backend,
                    batch_threshold=args.batch_threshold,
                    device=args.device, **opts)
    _emit(results, args.out)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
