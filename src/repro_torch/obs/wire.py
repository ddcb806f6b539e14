"""Glue between `lab.ObsSpec` and live instruments.

Kept here (not in ``lab``) so `ClusterRuntime`-level code — including a
federation that builds member runtimes itself — can instantiate
instruments without importing the lab layer. The spec is
duck-typed: anything with ``trace`` / ``probe_every`` / ``ring`` (and
optionally ``metrics`` / ``anomaly`` / ``anomaly_params`` /
``latency_sample``) attributes works.
"""

from __future__ import annotations

from dataclasses import dataclass

from .anomaly import AnomalyMonitor
from .monitor import CriticalPointMonitor
from .probe import ProbeSeries
from .registry import RegistryCollector
from .tracer import Tracer

__all__ = ["Instruments", "build_instruments", "export_obs"]


@dataclass
class Instruments:
    tracer: Tracer | None = None
    probe: ProbeSeries | None = None
    monitor: CriticalPointMonitor | None = None
    collector: RegistryCollector | None = None
    anomaly: AnomalyMonitor | None = None

    @property
    def any(self) -> bool:
        return (self.tracer is not None or self.probe is not None
                or self.monitor is not None or self.collector is not None
                or self.anomaly is not None)

    @property
    def registry(self):
        return None if self.collector is None else self.collector.registry

    def runtime_kwargs(self) -> dict:
        """Keyword arguments for ``ClusterRuntime(...)``."""
        kw = {"tracer": self.tracer, "probe": self.probe,
              "trigger_monitor": self.monitor, "anomaly": self.anomaly}
        if self.collector is not None:
            kw["decision_sink"] = self.collector
        return kw


def build_instruments(spec) -> Instruments:
    """ObsSpec -> live instruments; a None spec yields empty Instruments."""
    if spec is None:
        return Instruments()
    stride = int(getattr(spec, "latency_sample", 8) or 8)
    tracer = (Tracer(ring=spec.ring, latency_sample=stride)
              if spec.trace else None)
    probe = (ProbeSeries(spec.probe_every)
             if spec.probe_every is not None else None)
    monitor = CriticalPointMonitor()
    collector = (RegistryCollector()
                 if getattr(spec, "metrics", False) else None)
    anomaly = None
    if getattr(spec, "anomaly", False):
        params = dict(getattr(spec, "anomaly_params", None) or {})
        anomaly = AnomalyMonitor(monitor=monitor, **params)
    ins = Instruments(tracer=tracer, probe=probe, monitor=monitor,
                      collector=collector, anomaly=anomaly)
    if collector is not None:
        collector.bind_instruments(ins)
    return ins


def export_obs(ins: Instruments, *, include_trace: bool = True) -> dict:
    """Instruments -> the JSON-safe ``RunResult.extras["obs"]`` payload."""
    out: dict = {}
    if ins.tracer is not None:
        out["decision_stats"] = ins.tracer.decision_stats()
        out["trace_events"] = ins.tracer.n_events
        out["trace_dropped"] = ins.tracer.n_dropped
        if include_trace:
            out["chrome_trace"] = ins.tracer.to_chrome_trace()
    if ins.probe is not None:
        out["probes"] = ins.probe.to_dict()
    if ins.monitor is not None:
        out["trigger"] = ins.monitor.to_dict()
    if ins.anomaly is not None:
        out["alerts"] = ins.anomaly.to_dict()
    if ins.collector is not None:
        ins.collector.refresh()
        out["metrics"] = ins.collector.registry.snapshot()
    return out
