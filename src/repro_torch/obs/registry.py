"""Label-aware metrics registry: the scrapeable half of the ops plane.

Three primitive families — :class:`Counter`, :class:`Gauge`,
:class:`Histogram` — live in one :class:`MetricsRegistry` and are updated
in O(1) (dict hit + float add; histograms bisect a fixed bucket table).
The registry itself is storage-only: what feeds it is the
:class:`RegistryCollector`, which speaks the engine's decision-sink
protocol (``place`` / ``migrate`` / ``evict`` / ``complete`` /
``trigger`` / ``alert``) for the streaming counters and histograms, and
pulls point-in-time state (queue depth, per-recursion-level imbalance,
the full ``Metrics.summary()`` schema, tracer latency stats) into gauges
at :meth:`RegistryCollector.refresh` — i.e. at scrape time, so sampling
costs nothing between scrapes.

Two invariants the tests pin down:

* a refreshed snapshot agrees with ``Metrics.summary()`` on every shared
  key (the gauges *are* the summary, re-expressed), and the sink-fed
  completion counter independently reconciles with ``completed``;
* histogram bucket boundaries are fixed and log-spaced
  (:func:`log_buckets`), so cumulative bucket counts are monotone by
  construction and two registries can be merged bucket-by-bucket
  (:func:`merge_registries`, used for federation-wide scrapes).
"""

from __future__ import annotations

from bisect import bisect_left

__all__ = ["log_buckets", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "RegistryCollector", "FanoutSink",
           "merge_registries", "DEFAULT_BUCKETS"]

_INF = float("inf")


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple:
    """Fixed log-spaced histogram bounds covering [lo, hi]: ``per_decade``
    bounds per factor of 10, each rounded to 3 significant digits so the
    exposition stays readable (1e-3, 2.15e-3, 4.64e-3, 1e-2, ...)."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    out, step, x = [], 10.0 ** (1.0 / per_decade), float(lo)
    while x <= hi * (1.0 + 1e-9):
        out.append(float(f"{x:.3g}"))
        x *= step
    return tuple(out)


#: default bounds for simulated-time histograms (wait/response): six
#: decades around "one work unit on a unit-power node"
DEFAULT_BUCKETS = log_buckets(1e-2, 1e4, per_decade=3)


class _Child:
    """One labeled series inside a family."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _HistChild:
    __slots__ = ("counts", "total", "sum")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 for the +Inf bucket
        self.total = 0
        self.sum = 0.0


class _Family:
    """Shared machinery: a metric name, its label names, and one child
    per label-value combination. With no labels the family has exactly
    one child and the update methods act on it directly."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._children: dict[tuple, object] = {}
        if not self.label_names:
            self._default = self._make_child()
            self._children[()] = self._default

    def _make_child(self):
        return _Child()

    def labels(self, **labels):
        """Resolve (creating on first use) the child for one label-value
        combination; hot paths resolve once and keep the handle."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._make_child()
        return child

    def samples(self):
        """Yield ``(label_values, child)`` in insertion order."""
        return self._children.items()


class Counter(_Family):
    """Monotone counter; ``inc`` is one dict hit + one float add."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        child = self._default if not labels else self.labels(**labels)
        child.value += value

    def get(self, **labels) -> float:
        return (self._default if not labels
                else self.labels(**labels)).value


class Gauge(_Family):
    """Point-in-time value; refreshed wholesale at scrape time."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        child = self._default if not labels else self.labels(**labels)
        child.value = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        child = self._default if not labels else self.labels(**labels)
        child.value += value

    def get(self, **labels) -> float:
        return (self._default if not labels
                else self.labels(**labels)).value


class Histogram(_Family):
    """Fixed-bound cumulative histogram (Prometheus semantics: bucket
    ``le=b`` counts observations <= b, ``+Inf`` counts everything)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: tuple = (),
                 buckets: tuple = DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        if not self.buckets:
            raise ValueError(f"{name}: need at least one bucket bound")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"{name}: bucket bounds must be strictly "
                             f"increasing")
        super().__init__(name, help, labels)

    def _make_child(self):
        return _HistChild(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        child = self._default if not labels else self.labels(**labels)
        child.counts[bisect_left(self.buckets, value)] += 1
        child.total += 1
        child.sum += value

    def cumulative(self, child) -> list[int]:
        """Per-``le`` cumulative counts (including +Inf last) — monotone
        nondecreasing by construction."""
        out, acc = [], 0
        for c in child.counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    """Named families, each created once (get-or-create semantics)."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _get(self, name: str, factory, kind: str, **kwargs):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = factory(name, **kwargs)
        elif fam.kind != kind:
            raise ValueError(f"{name} already registered as {fam.kind}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: tuple = ()) -> Counter:
        return self._get(name, Counter, "counter", help=help, labels=labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Gauge:
        return self._get(name, Gauge, "gauge", help=help, labels=labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, "histogram", help=help,
                         labels=labels, buckets=buckets)

    def families(self):
        return self._families.values()

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge series (KeyError if absent)."""
        return self._families[name].get(**labels)

    def snapshot(self) -> dict:
        """JSON-safe dump: ``{name: {type, help, samples}}`` where samples
        map a ``label=value`` string (or ``""``) to the value — counters
        and gauges a float, histograms ``{count, sum, buckets}``."""
        out = {}
        for fam in self._families.values():
            samples = {}
            for key, child in fam.samples():
                label = ",".join(f"{n}={v}"
                                 for n, v in zip(fam.label_names, key))
                if fam.kind == "histogram":
                    samples[label] = {
                        "count": child.total, "sum": child.sum,
                        "buckets": fam.cumulative(child)}
                else:
                    samples[label] = child.value
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "samples": samples}
        return out


def merge_registries(registries, label: str, values) -> MetricsRegistry:
    """Merge per-member registries into one federation-wide registry,
    tagging every series with an extra ``label`` (e.g. ``member="m0"``).
    Counters/gauges copy through; histograms with identical bounds merge
    bucket-by-bucket. Series names and label names must agree."""
    merged = MetricsRegistry()
    for reg, tag in zip(registries, values):
        for fam in reg.families():
            names = (label,) + fam.label_names
            if fam.kind == "histogram":
                out = merged.histogram(fam.name, fam.help, labels=names,
                                       buckets=fam.buckets)
                for key, child in fam.samples():
                    lv = dict(zip(fam.label_names, key))
                    dst = out.labels(**{label: tag}, **lv)
                    for i, c in enumerate(child.counts):
                        dst.counts[i] += c
                    dst.total += child.total
                    dst.sum += child.sum
            else:
                ctor = merged.counter if fam.kind == "counter" \
                    else merged.gauge
                out = ctor(fam.name, fam.help, labels=names)
                for key, child in fam.samples():
                    lv = dict(zip(fam.label_names, key))
                    out.labels(**{label: tag}, **lv).value += child.value
    return merged


class FanoutSink:
    """Forward every decision-sink call to each child sink in order.
    Missing methods on a child are skipped (older sinks predate
    ``alert``). A raising child never starves its siblings — every child
    is delivered to first, then the first exception re-raises so the
    engine's guard still counts it in ``sink_errors``."""

    def __init__(self, sinks):
        self.sinks = list(sinks)

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)

        def fan(*args):
            err = None
            for sink in self.sinks:
                fn = getattr(sink, method, None)
                if fn is None:
                    continue
                try:
                    fn(*args)
                except Exception as exc:  # noqa: BLE001 — re-raised below
                    if err is None:
                        err = exc
            if err is not None:
                raise err
        return fan

    def bind(self, runtime) -> None:
        for sink in self.sinks:
            fn = getattr(sink, "bind", None)
            if fn is not None:
                fn(runtime)


def attach_collector(runtime, collector: "RegistryCollector | None" = None
                     ) -> "RegistryCollector":
    """Get-or-create the runtime's collector: reuse one already bound
    (from ``ObsSpec(metrics=True)`` or a service), otherwise install
    ``collector`` (or a fresh one) alongside any existing sink."""
    bound = getattr(runtime, "_collector", None)
    if bound is not None:
        return bound
    collector = RegistryCollector() if collector is None else collector
    existing = runtime._sink
    if existing is None:
        runtime._sink = collector
    elif isinstance(existing, FanoutSink):
        existing.sinks.append(collector)
    else:
        runtime._sink = FanoutSink([existing, collector])
    collector.bind(runtime)
    return collector


class RegistryCollector:
    """Feeds a :class:`MetricsRegistry` from the engine.

    Streaming path (O(1), called by the engine as decisions happen):
    decisions by kind, per-tier wait/response histograms, trigger
    fires/skips, anomaly alerts by kind. Pull path (:meth:`refresh`,
    called at scrape time against the bound runtime): queue depth and
    live-task gauges, hyper-grid imbalance per recursion level, decision-
    latency stats from the tracer, ``sink_errors``, and one gauge per
    numeric ``Metrics.summary()`` key (``sched_makespan``,
    ``sched_completed``, ...) so a scrape always carries the canonical
    schema.
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self._decisions = r.counter(
            "sched_decisions_total",
            "scheduling decisions emitted through the decision sink",
            labels=("kind",))
        self._completions = r.counter(
            "sched_tasks_completed_total",
            "task completions observed by the sink")
        self._response = r.histogram(
            "sched_response_time",
            "arrival -> completion, simulated time units",
            labels=("tier",))
        self._wait = r.histogram(
            "sched_wait_time",
            "arrival -> start of the completing attempt, simulated time "
            "units", labels=("tier",))
        self._triggers = r.counter(
            "sched_trigger_total",
            "crossover-trigger verdicts", labels=("result",))
        self._sink_errors = r.counter(
            "sched_sink_errors_total",
            "decision-sink callbacks that raised (caught by the engine)")
        self._alerts = r.counter(
            "obs_alerts_total", "anomaly alerts", labels=("kind",))
        # hot-path handles, resolved once
        self._dec = {k: self._decisions.labels(kind=k)
                     for k in ("place", "migrate", "evict", "complete",
                               "trigger")}
        self._fired = self._triggers.labels(result="fired")
        self._skipped = self._triggers.labels(result="skipped")
        self._tiers: dict[int, tuple] = {}
        self._rt = None
        self._ins = None

    # -- wiring --------------------------------------------------------
    def bind(self, runtime) -> None:
        """Remember the runtime (the engine calls this when the collector
        is installed as its sink) so ``refresh()`` can pull state."""
        self._rt = runtime
        runtime._collector = self

    def bind_instruments(self, instruments) -> None:
        self._ins = instruments

    # -- sink protocol (O(1) streaming updates) ------------------------
    def place(self, t, task, node) -> None:
        self._dec["place"].value += 1.0

    def migrate(self, t, task, src, dst) -> None:
        self._dec["migrate"].value += 1.0

    def evict(self, t, task, running) -> None:
        self._dec["evict"].value += 1.0

    def complete(self, t, task, node) -> None:
        self._dec["complete"].value += 1.0
        self._completions.inc()
        tier = task.priority
        handles = self._tiers.get(tier)
        if handles is None:
            label = str(tier)
            handles = self._tiers[tier] = (
                self._response.labels(tier=label),
                self._wait.labels(tier=label))
        resp, wait = handles
        r = t - task.t_arrive
        resp.counts[bisect_left(self._response.buckets, r)] += 1
        resp.total += 1
        resp.sum += r
        started = task.t_attempt_start if task.t_attempt_start is not None \
            else t
        w = started - task.t_arrive
        wait.counts[bisect_left(self._wait.buckets, w)] += 1
        wait.total += 1
        wait.sum += w

    def trigger(self, t, fired) -> None:
        self._dec["trigger"].value += 1.0
        (self._fired if fired else self._skipped).value += 1.0

    def alert(self, t, record) -> None:
        self._alerts.inc(kind=record.get("kind", "unknown"))

    # -- scrape-time pull ----------------------------------------------
    def refresh(self, runtime=None) -> None:
        """Pull point-in-time state into gauges. ``runtime`` defaults to
        the bound one; a collector never bound is streaming-only."""
        from .probe import imbalance_by_level
        rt = self._rt if runtime is None else runtime
        if rt is None:
            return
        r = self.registry
        self._sink_errors._default.value = float(
            getattr(rt, "sink_errors", 0))
        for key, value in rt.metrics.summary().items():
            if value is None or isinstance(value, bool):
                continue
            value = float(value)
            if value != value:  # NaN: undefined ratio, no sample
                continue
            r.gauge("sched_" + key,
                    f"Metrics.summary()['{key}'] at scrape time").set(value)
        t = rt._now
        snap = rt.probe_snapshot(t)
        depth = r.gauge("sched_queue_depth",
                        "queued + running tasks", labels=("node",))
        for node, d in enumerate(snap["queue_depth"]):
            depth.set(float(d), node=node)
        r.gauge("sched_queued_tasks", "tasks queued cluster-wide").set(
            float(snap["queued_tasks"]))
        r.gauge("sched_blocked_tasks",
                "arrived tasks gated on DAG parents").set(
            float(snap["blocked_tasks"]))
        r.gauge("sched_in_flight", "tasks mid-migration").set(
            float(snap["in_flight"]))
        imb = r.gauge("sched_imbalance",
                      "hyper-grid imbalance I per recursion level",
                      labels=("level",))
        for level, value in enumerate(
                imbalance_by_level(snap["node_load"], rt.grid)):
            if value == value and value != _INF:
                imb.set(value, level=level)
        tracer = getattr(rt, "_tr", None)
        if tracer is not None:
            lat = r.gauge("sched_decision_latency_us",
                          "wall-clock decision latency from the tracer "
                          "reservoir", labels=("kind", "stat"))
            for kind, s in tracer.decision_stats().items():
                lat.set(s["mean_us"], kind=kind, stat="mean")
                lat.set(s["p99_us"], kind=kind, stat="p99")
                lat.set(s["p999_us"], kind=kind, stat="p999")
        anom = getattr(rt, "_anom", None)
        if anom is not None:
            r.gauge("obs_alerts_active",
                    "anomaly alerts raised so far").set(
                float(len(anom.alerts)))

    def scrape(self, runtime=None) -> str:
        """Refresh and render the OpenMetrics exposition."""
        from .export import to_openmetrics
        self.refresh(runtime)
        return to_openmetrics(self.registry)
