"""Exposition: OpenMetrics text rendering, a validating parser (the CI
lint step), a stdlib-http scrape endpoint, and stitched Chrome traces.

The text format follows the OpenMetrics conventions Prometheus scrapes:
``# TYPE`` / ``# HELP`` metadata per family (counter metadata uses the
name stem, samples carry the ``_total`` suffix), histograms expand to
cumulative ``_bucket{le=...}`` series plus ``_count`` / ``_sum``, and the
exposition ends with ``# EOF``. :func:`parse_openmetrics` re-reads that
format strictly — unknown sample names, missing metadata, a missing
``# EOF`` terminator, or non-monotone histogram buckets all raise — so a
round-trip through it is the test that a scrape is well-formed, and
``python -m repro_torch.obs.export FILE`` runs the same check standalone.

:func:`merge_chrome_traces` stitches per-member federation traces into
one Chrome/Perfetto payload: every member's process lanes move to a
disjoint pid range (named ``m0/nodes``, ``m1/scheduler``, ...), and
since lockstep members share the simulation clock the merged ``ts`` axis
is aligned by construction (an optional per-member offset handles
sources that do not).
"""

from __future__ import annotations

import json
import re
import sys

__all__ = ["to_openmetrics", "parse_openmetrics", "merge_chrome_traces",
           "MetricsHTTPServer", "write_metrics_jsonl"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ ]+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                 "charset=utf-8")


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(value: float) -> str:
    if value != value:
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labels_text(names, values, extra=()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def to_openmetrics(registry) -> str:
    """Render a :class:`~repro_torch.obs.registry.MetricsRegistry` as an
    OpenMetrics text exposition."""
    lines = []
    for fam in registry.families():
        stem = fam.name
        if fam.kind == "counter" and stem.endswith("_total"):
            stem = stem[:-len("_total")]
        lines.append(f"# TYPE {stem} {fam.kind}")
        if fam.help:
            lines.append(f"# HELP {stem} {_escape(fam.help)}")
        for key, child in fam.samples():
            if fam.kind == "histogram":
                acc = 0
                bounds = list(fam.buckets) + [float("inf")]
                for count, le in zip(child.counts, bounds):
                    acc += count
                    lt = _labels_text(fam.label_names, key,
                                      extra=(("le", _fmt(le)),))
                    lines.append(f"{stem}_bucket{lt} {acc}")
                lt = _labels_text(fam.label_names, key)
                lines.append(f"{stem}_count{lt} {child.total}")
                lines.append(f"{stem}_sum{lt} {_fmt(child.sum)}")
            else:
                suffix = "_total" if fam.kind == "counter" else ""
                lt = _labels_text(fam.label_names, key)
                lines.append(f"{stem}{suffix}{lt} {_fmt(child.value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _parse_value(text: str, where: str) -> float:
    if text == "+Inf":
        return float("inf")
    if text == "-Inf":
        return float("-inf")
    try:
        return float(text)
    except ValueError:
        raise ValueError(f"{where}: bad sample value {text!r}") from None


def parse_openmetrics(text: str) -> dict:
    """Strict parse of an OpenMetrics exposition.

    Returns ``{family_stem: {"type": ..., "help": ..., "samples":
    [(sample_name, labels_dict, value), ...]}}``. Raises ``ValueError``
    on malformed metadata or samples, samples without a preceding
    ``# TYPE``, counter samples missing the ``_total`` suffix, a missing
    ``# EOF`` terminator, or histogram series whose cumulative buckets
    decrease / lack a ``+Inf`` bound.
    """
    families: dict[str, dict] = {}
    seen_eof = False
    for i, line in enumerate(text.splitlines(), start=1):
        if seen_eof:
            raise ValueError(f"line {i}: content after # EOF")
        if line == "# EOF":
            seen_eof = True
            continue
        if not line:
            raise ValueError(f"line {i}: blank line in exposition")
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 3 or parts[0] != "#" \
                    or parts[1] not in ("TYPE", "HELP", "UNIT"):
                raise ValueError(f"line {i}: bad metadata {line!r}")
            _, kw, name = parts[:3]
            if not _NAME_RE.match(name):
                raise ValueError(f"line {i}: bad metric name {name!r}")
            fam = families.setdefault(
                name, {"type": None, "help": "", "samples": []})
            if kw == "TYPE":
                if fam["type"] is not None:
                    raise ValueError(f"line {i}: duplicate TYPE for {name}")
                fam["type"] = parts[3] if len(parts) > 3 else ""
                if fam["type"] not in ("counter", "gauge", "histogram",
                                       "summary", "untyped", "info"):
                    raise ValueError(
                        f"line {i}: unknown type {fam['type']!r}")
            elif kw == "HELP":
                fam["help"] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: bad sample line {line!r}")
        name, raw_labels = m.group("name"), m.group("labels")
        labels = dict(_LABEL_RE.findall(raw_labels)) if raw_labels else {}
        value = _parse_value(m.group("value"), f"line {i}")
        stem, matched = name, None
        for fam_name in families:
            if name == fam_name or (
                    name.startswith(fam_name + "_")
                    and name[len(fam_name):] in ("_total", "_bucket",
                                                 "_count", "_sum")):
                if matched is None or len(fam_name) > len(matched):
                    matched = fam_name
        if matched is None:
            raise ValueError(f"line {i}: sample {name!r} has no preceding "
                             f"# TYPE metadata")
        stem = matched
        fam = families[stem]
        suffix = name[len(stem):]
        if fam["type"] == "counter" and suffix != "_total":
            raise ValueError(f"line {i}: counter sample {name!r} must end "
                             f"in _total")
        if fam["type"] == "histogram" and suffix == "_bucket" \
                and "le" not in labels:
            raise ValueError(f"line {i}: histogram bucket without le label")
        fam["samples"].append((name, labels, value))
    if not seen_eof:
        raise ValueError("exposition does not end with # EOF")
    # histogram bucket monotonicity + +Inf terminator, per label set
    for stem, fam in families.items():
        if fam["type"] != "histogram":
            continue
        series: dict[tuple, list] = {}
        for name, labels, value in fam["samples"]:
            if not name.endswith("_bucket"):
                continue
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            series.setdefault(key, []).append(
                (_parse_value(labels["le"], stem), value))
        for key, buckets in series.items():
            buckets.sort(key=lambda b: b[0])
            if buckets[-1][0] != float("inf"):
                raise ValueError(f"{stem}{dict(key)}: no +Inf bucket")
            last = -1.0
            for le, count in buckets:
                if count < last:
                    raise ValueError(
                        f"{stem}{dict(key)}: bucket le={le} count "
                        f"{count} < previous {last} (not cumulative)")
                last = count
    return families


# ---------------------------------------------------------------------------
# stitched federation traces
# ---------------------------------------------------------------------------

#: pid stride per member in a merged trace (member k's lane ``pid`` maps
#: to ``k * _PID_STRIDE + pid``); the tracer uses pids 1..3
_PID_STRIDE = 16


def merge_chrome_traces(traces, names, offsets=None) -> dict:
    """Merge per-member Chrome traces into one clock-aligned payload.

    Each member's events keep their relative layout but move to a
    disjoint pid range, with process names prefixed by the member name
    (``m0/nodes``). ``offsets`` (sim-time seconds per member) shifts
    ``ts`` for sources that do not already share a clock; lockstep
    federation members do, so the default is no shift.
    """
    if offsets is None:
        offsets = [0.0] * len(traces)
    events = []
    other = {"members": {}, "clock": "aligned"}
    for k, (trace, name, off) in enumerate(zip(traces, names, offsets)):
        base = k * _PID_STRIDE
        for ev in trace.get("traceEvents", ()):
            ev = dict(ev)
            ev["pid"] = base + ev.get("pid", 0)
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                ev["args"] = {"name": f"{name}/{ev['args']['name']}"}
            elif off:
                ev["ts"] = ev.get("ts", 0.0) + off * 1e6
            events.append(ev)
        other["members"][name] = trace.get("otherData", {})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


# ---------------------------------------------------------------------------
# serve wiring: JSONL stream + stdlib scrape endpoint
# ---------------------------------------------------------------------------

def write_metrics_jsonl(fh, t: float, registry) -> None:
    """Append one ``{"t": ..., "metrics": snapshot}`` line."""
    fh.write(json.dumps({"t": t, "metrics": registry.snapshot()},
                        allow_nan=False) + "\n")


class MetricsHTTPServer:
    """Minimal scrape endpoint on the stdlib http server: ``GET /metrics``
    answers with ``scrape_fn()`` as OpenMetrics text. Runs on a daemon
    thread; ``close()`` shuts it down."""

    def __init__(self, scrape_fn, port: int = 0, host: str = "127.0.0.1"):
        import http.server
        import threading

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = scrape_fn().encode()
                except Exception as exc:  # noqa: BLE001 — surface as 500
                    self.send_error(500, str(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", _CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def main(argv=None) -> int:
    """OpenMetrics lint: ``python -m repro_torch.obs.export FILE...`` parses
    each exposition strictly and reports family/sample counts."""
    import argparse
    parser = argparse.ArgumentParser(
        description="validate OpenMetrics text expositions")
    parser.add_argument("files", nargs="+", help="scrape files to lint")
    args = parser.parse_args(argv)
    status = 0
    for path in args.files:
        with open(path) as fh:
            text = fh.read()
        try:
            families = parse_openmetrics(text)
        except ValueError as exc:
            print(f"{path}: INVALID: {exc}", file=sys.stderr)
            status = 1
            continue
        n_samples = sum(len(f["samples"]) for f in families.values())
        print(f"{path}: OK ({len(families)} families, {n_samples} samples)")
    return status


if __name__ == "__main__":
    sys.exit(main())
