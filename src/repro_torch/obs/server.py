"""Live telemetry frontend: Prometheus text exposition + stdlib HTTP server
(the port's own copy of ``repro/obs/server.py``).

Three pieces, all dependency-free:

- :func:`render_exposition` turns one or more :class:`MetricsRegistry`
  instances (plus optional derived gauges) into Prometheus text
  exposition format 0.0.4 — counters as ``<name>_total``, gauges as-is,
  and the log-bucketed histograms as native cumulative
  ``_bucket{le=...}`` / ``_sum`` / ``_count`` series whose ``le`` edges
  are the histogram's own geometric bucket edges.  Registry keys may
  carry labels (``watchdog_amax{layer="decode.00"}``, built with
  :func:`repro_torch.obs.metrics.labeled`); series sharing a base name are
  grouped into one ``# TYPE``-declared family.

- :func:`validate_exposition` is a grammar + semantics checker for that
  format (used by the tests and ``chip_smoke.py``): line shapes, names,
  label syntax, TYPE-before-samples, histogram ``le`` monotonicity,
  cumulative bucket counts, and ``+Inf`` bucket == ``_count``.

- :class:`MetricsServer` serves ``/metrics`` (exposition), ``/healthz``,
  ``/snapshot`` (JSON) and the event tail ``/events?n=N`` from a daemon
  thread bound to ``127.0.0.1``.  It *polls*: the
  handler calls a collector closure that reads live registries; nothing
  on the engine dispatch path knows the server exists.
"""

from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Mapping, Optional, Sequence
from urllib.parse import parse_qs

from repro_torch.obs.metrics import MetricsRegistry, split_labels

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    name = _SANITIZE_RE.sub("_", name)
    if not name or not _NAME_RE.match(name):
        name = "_" + name
    return name


def _fmt(value) -> str:
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{_sanitize(k)}="{_escape_label(str(v))}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _families(items: Iterable[tuple[str, object]], prefix: str):
    """Group registry entries by sanitized family name, splitting labels."""
    fams: dict[str, list[tuple[dict, object]]] = {}
    for key, obj in items:
        base, labels = split_labels(key)
        fam = _sanitize(f"{prefix}_{base}" if prefix else base)
        fams.setdefault(fam, []).append((labels, obj))
    return sorted(fams.items())


def render_exposition(registries: Sequence[MetricsRegistry],
                      extra_gauges: Optional[Mapping[str, float]] = None,
                      prefix: str = "repro") -> str:
    """Render registries (+ derived scalar gauges) as Prometheus text."""
    lines: list[str] = []
    counters: list[tuple[str, object]] = []
    gauges: list[tuple[str, object]] = []
    histograms: list[tuple[str, object]] = []
    for reg in registries:
        with reg.lock:
            counters.extend(reg.counters.items())
            gauges.extend(reg.gauges.items())
            histograms.extend(reg.histograms.items())

    for fam, series in _families(counters, prefix):
        name = fam + "_total"
        lines.append(f"# TYPE {name} counter")
        for labels, c in series:
            lines.append(f"{name}{_labels_str(labels)} {_fmt(c.value)}")

    gauge_items = list(gauges)
    for k, v in (extra_gauges or {}).items():
        gauge_items.append((k, _Scalar(v)))
    for fam, series in _families(gauge_items, prefix):
        lines.append(f"# TYPE {fam} gauge")
        for labels, g in series:
            lines.append(f"{fam}{_labels_str(labels)} {_fmt(g.value)}")

    for fam, series in _families(histograms, prefix):
        lines.append(f"# TYPE {fam} histogram")
        for labels, h in series:
            # counts/sum are mutated by the engine thread while we read;
            # snapshot the list once so cumulative sums stay consistent
            counts = list(h.counts)
            cum = 0
            for i, c in enumerate(counts):
                cum += c
                le = ("+Inf" if i == len(counts) - 1
                      else _fmt(h.edge(i)))
                ls = _labels_str({**labels, "le": le})
                lines.append(f"{fam}_bucket{ls} {cum}")
            ls = _labels_str(labels)
            lines.append(f"{fam}_sum{ls} {_fmt(h.sum)}")
            lines.append(f"{fam}_count{ls} {cum}")

    return "\n".join(lines) + "\n"


class _Scalar:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


# ---------------------------------------------------------------------------
# exposition grammar validator (for tests + the CI schema check)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r" (?P<value>[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf)|NaN)"
    r"(?: [0-9]+)?$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|histogram|summary|untyped)$")
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) .*$")


def _parse_labels(text: str) -> Optional[dict[str, str]]:
    body = text[1:-1].rstrip(",")
    if not body:
        return {}
    labels: dict[str, str] = {}
    pos = 0
    while pos < len(body):
        m = _LABEL_RE.match(body, pos)
        if m is None:
            return None
        labels[m.group(1)] = m.group(2)
        pos = m.end()
        if pos < len(body):
            if body[pos] != ",":
                return None
            pos += 1
    return labels


def validate_exposition(text: str) -> list[str]:
    """Check Prometheus text exposition; return a list of problems.

    Enforces line grammar, TYPE declarations preceding their samples,
    histogram family completeness (``_bucket``/``_sum``/``_count``),
    ``le`` monotonicity, cumulative bucket counts, and the ``+Inf``
    bucket agreeing with ``_count``.  Empty list == valid.
    """
    errors: list[str] = []
    types: dict[str, str] = {}
    # histogram bookkeeping: (family, frozenset of non-le labels) ->
    # {"buckets": [(le, value)], "count": v, "sum": seen}
    hists: dict[tuple, dict] = {}

    for n, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                if m.group(1) in types:
                    errors.append(f"line {n}: duplicate TYPE for {m.group(1)}")
                types[m.group(1)] = m.group(2)
                continue
            if _HELP_RE.match(line):
                continue
            errors.append(f"line {n}: malformed comment: {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            errors.append(f"line {n}: malformed sample: {line!r}")
            continue
        name = m.group("name")
        labels = _parse_labels(m.group("labels")) if m.group("labels") else {}
        if labels is None:
            errors.append(f"line {n}: malformed labels: {line!r}")
            continue
        family, suffix = name, ""
        for sfx in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(sfx) and name[: -len(sfx)] in types:
                family, suffix = name[: -len(sfx)], sfx
                break
        declared = types.get(name) or types.get(family)
        if declared is None:
            errors.append(f"line {n}: sample {name} has no TYPE declaration")
            continue
        if declared == "histogram" and suffix in ("_bucket", "_sum", "_count"):
            key = (family, frozenset((k, v) for k, v in labels.items()
                                     if k != "le"))
            h = hists.setdefault(key, {"buckets": [], "count": None,
                                       "sum": False})
            value = float(m.group("value").replace("Inf", "inf"))
            if suffix == "_bucket":
                if "le" not in labels:
                    errors.append(f"line {n}: histogram bucket without le")
                    continue
                le = labels["le"]
                le_v = math.inf if le == "+Inf" else float(le)
                h["buckets"].append((le_v, value, n))
            elif suffix == "_count":
                h["count"] = value
            else:
                h["sum"] = True
        elif declared == "counter":
            if float(m.group("value").replace("Inf", "inf")) < 0:
                errors.append(f"line {n}: negative counter {name}")

    for (family, _labels), h in hists.items():
        edges = h["buckets"]
        if not edges:
            errors.append(f"histogram {family}: no buckets")
            continue
        for (a, ca, _), (b, cb, ln) in zip(edges, edges[1:]):
            if b <= a:
                errors.append(f"line {ln}: {family} le not increasing")
            if cb < ca:
                errors.append(f"line {ln}: {family} buckets not cumulative")
        if not math.isinf(edges[-1][0]):
            errors.append(f"histogram {family}: missing +Inf bucket")
        if h["count"] is None:
            errors.append(f"histogram {family}: missing _count")
        elif math.isinf(edges[-1][0]) and edges[-1][1] != h["count"]:
            errors.append(f"histogram {family}: +Inf bucket "
                          f"{edges[-1][1]} != _count {h['count']}")
        if not h["sum"]:
            errors.append(f"histogram {family}: missing _sum")
    return errors


# ---------------------------------------------------------------------------
# the HTTP frontend
# ---------------------------------------------------------------------------

# collector contract: () -> (registries, derived_gauges)
Collector = Callable[[], tuple[Sequence[MetricsRegistry],
                               Mapping[str, float]]]


class MetricsServer:
    """Daemon-thread HTTP server for live scraping.

    ``collect`` is called per request and must return
    ``(registries, derived_gauges)`` — typically a closure over the LLM
    that reads whatever engine is currently live.  ``port=0`` binds an
    ephemeral port (read it back from ``.port``).

    ``events`` (optional) returns the live ``EventLog``; when given, the
    server also answers ``/events?n=N`` with the newest N scheduler
    decisions from the in-memory window as JSON — a fleet scrape can grab
    recent decisions without tailing the JSONL sink.
    """

    def __init__(self, collect: Collector, port: int = 0,
                 host: str = "127.0.0.1", events=None):
        self._collect = collect
        self._events = events
        self._host = host
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        collect = self._collect
        events = self._events

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
                pass  # scrapes should not spam the serving console

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - stdlib name
                path, _, query = self.path.partition("?")
                try:
                    if path == "/metrics":
                        regs, gauges = collect()
                        body = render_exposition(regs, gauges)
                        self._send(200, body.encode(), CONTENT_TYPE)
                    elif path == "/healthz":
                        self._send(200, b"ok\n", "text/plain; charset=utf-8")
                    elif path == "/snapshot":
                        regs, gauges = collect()
                        doc = {"registries": [r.snapshot() for r in regs],
                               "derived": dict(gauges)}
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    elif path == "/events" and events is not None:
                        n = 100
                        qs = parse_qs(query)
                        if "n" in qs:
                            try:
                                n = int(qs["n"][0])
                            except (ValueError, IndexError):
                                self._send(400, b"bad n\n",
                                           "text/plain; charset=utf-8")
                                return
                        log = events()
                        tail = log.tail(n) if log is not None else []
                        doc = {"events": tail, "returned": len(tail),
                               "window": len(log) if log is not None else 0}
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found\n",
                                   "text/plain; charset=utf-8")
                except Exception as e:  # a broken scrape must not kill serving
                    try:
                        self._send(500, f"collect failed: {e}\n".encode(),
                                   "text/plain; charset=utf-8")
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((self._host, self._requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-metrics-server",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None
