"""``federated`` — the fourth ``repro_torch.lab`` backend.

Consumes a :class:`~repro_torch.federation.specs.Federation` (not a single
Scenario) and returns ONE aggregate :class:`~repro_torch.lab.result.RunResult`
in the canonical metric schema, with every per-member RunResult under
``extras["members"]`` and the WAN accounting under ``extras["wan"]`` — so
``lab.run`` / ``lab.sweep`` / the CLI treat a federation exactly like any
other experiment.

Execution models:

* event-driven (the reference): N ``ClusterRuntime`` s (or nested
  federations) under ``FederatedRuntime``, driven per ``spec.mode`` —
  ``async`` (event-heap stepping, the default) or ``lockstep``
  (conformance epochs). Reported as ``{mode}-events``.
* a vectorized fast path for the no-exchange case: a link-free federation
  of flat members that are uniform-but-for-seed lowers to ONE batched run
  on the existing batched backend, through the hand-written scan and
  dispatch kernels on the CUDA device — the isolated baseline of a
  federation benchmark costs one batched run, not N engine runs.
  Auto-selected; force with ``vectorize=True/False``.

``device`` is the port's one option beyond the JAX package's: it reaches
the vectorized path alone, which runs on the CUDA device unless ``device``
says otherwise (``device="cpu"`` runs the kernels' plain PyTorch versions;
with no GPU and no ``device`` it raises, never falls back). The
event-driven path is host code and ignores it.
"""

from __future__ import annotations

from ..lab.backends import (
    Backend,
    BackendError,
    get_backend,
    register_backend,
    uniform_but_for_seed,
)
from ..lab.result import RunResult, make_metrics
from ..obs import export_obs
from ..runtime.metrics import Metrics
from .runtime import FederatedRuntime
from .specs import Federation

__all__ = ["FederatedBackend"]


def _member_result(member, metrics: Metrics, model: str) -> RunResult:
    return RunResult(
        fingerprint=member.fingerprint(), backend="federated",
        backend_options={"model": model},
        metrics=make_metrics(**metrics.summary()),
        scenario_name=member.name)


@register_backend
class FederatedBackend(Backend):
    name = "federated"

    def eligible(self, spec):
        if not getattr(spec, "is_federation", False):
            return ("runs Federation specs (N member Scenarios over a WAN "
                    "topology); a single Scenario runs on events/batched/"
                    "legacy")
        events = get_backend("events")
        for i, member in enumerate(spec.members):
            # a member may itself be a federation (recursion level k+2):
            # its own members must be eligible all the way down
            if getattr(member, "is_federation", False):
                reason = self.eligible(member)
            else:
                reason = events.eligible(member)
            if reason is not None:
                return f"member {i} ({member.name or 'unnamed'}): {reason}"
        try:
            spec.topology.resolve(spec.n_members)
        except ValueError as exc:
            return str(exc)
        return None

    def run(self, spec, *, vectorize: bool | None = None, device=None,
            **options) -> RunResult:
        """Run the federation on the event-driven model or, when it is
        link-free and flat, the vectorized one. ``device`` reaches the
        vectorized path's batched run only (see the module docstring)."""
        if options:
            raise TypeError(f"federated backend options: vectorize and "
                            f"device only; got {sorted(options)}")
        self.check(spec)
        members = list(spec.members)
        links = spec.topology.resolve(spec.n_members)
        batched = get_backend("batched")
        nested = any(getattr(m, "is_federation", False) for m in members)
        can_vectorize = (not links and not nested
                         and uniform_but_for_seed(members)
                         and batched.eligible(members[0]) is None)
        if vectorize is None:
            vectorize = can_vectorize
        elif vectorize and not can_vectorize:
            raise BackendError(
                "federated backend: the vectorized fast path covers "
                "link-free federations whose members are uniform but for "
                "seed/name and batched-eligible; this one "
                + ("has WAN links" if links else
                   "has nested federation members" if nested else
                   "is not expressible on the batched backend"))
        if vectorize:
            return self._run_vectorized(spec, members, batched, device)
        return self._run_events(spec, members)

    # -- event-driven (reference; async or lockstep per spec.mode) ----------
    def _run_events(self, spec: Federation, members) -> RunResult:
        model = f"{spec.mode}-events"
        frt = FederatedRuntime(spec)
        report = frt.run()
        per_member = [_member_result(m, rm, model)
                      for m, rm in zip(members, report.members)]
        extras = {
            "members": [r.to_dict() for r in per_member],
            "wan": report.wan.to_dict(),
            "epochs": report.epochs,
        }
        if frt.wan_stream is not None:
            # per-member tracer/probe/monitor payloads plus the epoch-level
            # WAN stream (member loads + in-flight work over time)
            extras["obs"] = {
                "members": [export_obs(ins) if ins.any else None
                            for ins in frt.instruments],
                "wan_stream": frt.wan_stream,
            }
            stitched = frt.stitched_trace()
            if stitched is not None:
                # one clock-aligned Chrome trace across every traced
                # member; WAN hand-offs appear as a single causal chain
                extras["obs"]["stitched_trace"] = stitched
        return RunResult(
            fingerprint=spec.fingerprint(), backend=self.name,
            backend_options={
                "model": model,
                "exchange": spec.exchange,
                "n_members": spec.n_members,
                "links": len(spec.topology.resolve(spec.n_members)),
                "exchange_period": spec.exchange_period,
            },
            metrics=make_metrics(**report.aggregate.summary()),
            extras=extras,
            scenario_name=spec.name)

    # -- vectorized isolated fast path --------------------------------------
    def _run_vectorized(self, spec: Federation, members, batched,
                        device) -> RunResult:
        results = batched.run_many(members, device=device)
        agg: dict = {}
        completed = sum(r["completed"] for r in results)
        agg["arrived"] = sum(r["arrived"] for r in results)
        agg["completed"] = completed
        agg["makespan"] = max(r["makespan"] for r in results)
        if completed:
            agg["mean_response"] = sum(
                r["mean_response"] * r["completed"] for r in results
                if r["completed"]) / completed
        agg["moved_units"] = sum(r["moved_units"] for r in results)
        agg["moved_packets"] = sum(r["moved_packets"] for r in results)
        agg["trigger_evals"] = sum(r["trigger_evals"] for r in results)
        agg["trigger_fires"] = sum(r["trigger_fires"] for r in results)
        agg["restarts"] = sum(r["restarts"] for r in results)
        agg["failures"] = sum(r["failures"] for r in results)
        agg["joins"] = sum(r["joins"] for r in results)
        agg["resizes"] = sum(r["resizes"] for r in results)
        agg["evictions"] = sum(r["evictions"] for r in results)
        agg["wasted_work"] = sum(r["wasted_work"] for r in results)
        agg["admitted_work"] = sum(r["admitted_work"] for r in results)
        # p99/mean_wait stay None: the fluid batch keeps no per-task
        # response sample to pool across members
        return RunResult(
            fingerprint=spec.fingerprint(), backend=self.name,
            backend_options={
                "model": "fluid-batched",
                "n_members": spec.n_members,
                "links": 0,
                "ignored": ["exchange_period", "admission_margin"],
            },
            metrics=make_metrics(**agg),
            extras={
                "members": [r.to_dict() for r in results],
                "wan": {"epochs": 0, "migrations": 0, "moved_units": 0.0,
                        "moved_packets": 0.0, "rejected": 0, "steals": 0,
                        "evictions_retargeted": 0, "evictions_dropped": 0},
            },
            scenario_name=spec.name)
