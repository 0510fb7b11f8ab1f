"""Metrics primitives: counters, gauges, log-bucketed histograms.

The port's own copy of ``repro/obs/metrics.py`` (jax-free there too, but
the port imports nothing of the reference).  Engine code *emits*
(``inc`` / ``set`` / ``observe``) and summaries are *derived*
(``serving.metrics.EngineMetrics.report``).

``Histogram`` buckets observations geometrically (``base * growth**i``
edges), the usual shape for latencies that span orders of magnitude, and
keeps the raw observations beside the bucket counts: a serving run
observes one value per request or per step, so percentiles
(``p50/p95/p99``) are exact, numpy-style interpolation.
``bucket_percentile`` gives the bucket-interpolated estimate.  Registry
keys may carry Prometheus labels (:func:`labeled`); get-or-create and
whole-registry reads take ``MetricsRegistry.lock``, so the metrics
server's thread can scrape while the engine emits.
"""

from __future__ import annotations

import math
import threading
from typing import Optional


def labeled(name: str, **labels) -> str:
    """Build a registry key carrying Prometheus-style labels.

    ``labeled("watchdog_act_sat", layer="decode.00")`` ->
    ``watchdog_act_sat{layer="decode.00"}``.  The exposition renderer
    groups series by the base name (everything before ``{``), so one
    metric family can hold many labeled series in a flat registry.
    """
    if not labels:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


def split_labels(key: str) -> tuple[str, dict[str, str]]:
    """Inverse of :func:`labeled`: registry key -> (base name, labels)."""
    base, brace, rest = key.partition("{")
    if not brace:
        return key, {}
    labels: dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels[k.strip()] = v.strip().strip('"')
    return base, labels


class Counter:
    """Monotonic accumulator (ints stay ints; timers add floats)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-value (or running-max) metric."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0):
        self.name = name
        self.value = value

    def set(self, value) -> None:
        self.value = value

    def set_max(self, value) -> None:
        if value > self.value:
            self.value = value


class Histogram:
    """Log-bucketed histogram with exact percentiles from retained samples.

    Bucket ``0`` holds values ``<= base``; bucket ``i >= 1`` holds
    ``(base * growth**(i-1), base * growth**i]``; the last bucket is
    open-ended.  Defaults cover 1 microsecond .. ~3.9 hours at
    ``growth=2``.
    """

    __slots__ = ("name", "base", "growth", "counts", "samples",
                 "total", "sum", "min", "max")

    def __init__(self, name: str, base: float = 1e-6, growth: float = 2.0,
                 n_buckets: int = 44):
        if base <= 0 or growth <= 1 or n_buckets < 2:
            raise ValueError("need base > 0, growth > 1, n_buckets >= 2")
        self.name = name
        self.base = base
        self.growth = growth
        self.counts = [0] * n_buckets
        self.samples: list[float] = []
        self.total = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    @property
    def n_buckets(self) -> int:
        return len(self.counts)

    def bucket_index(self, value: float) -> int:
        if value <= self.base:
            return 0
        i = 1 + math.floor(math.log(value / self.base, self.growth))
        # a value sitting exactly on edge base*growth**(i-1) belongs to
        # bucket i-1 (edges are inclusive upper bounds); float log can
        # round either way, so fix up against the true edges
        while i > 0 and value <= self.edge(i - 1):
            i -= 1
        while value > self.edge(i) and i < self.n_buckets - 1:
            i += 1
        return min(i, self.n_buckets - 1)

    def edge(self, i: int) -> float:
        """Inclusive upper edge of bucket ``i``."""
        return self.base * self.growth ** i

    def observe(self, value) -> None:
        value = float(value)
        self.counts[self.bucket_index(value)] += 1
        self.samples.append(value)
        self.total += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (linear interpolation, numpy-style).
        0.0 when nothing was observed."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = math.floor(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def bucket_percentile(self, q: float) -> float:
        """Bucket-interpolated percentile (what a sample-free histogram
        could report): the upper edge-weighted position inside the bucket
        the q-th observation falls in."""
        if not self.total:
            return 0.0
        target = (q / 100.0) * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c:
                lo = 0.0 if i == 0 else self.edge(i - 1)
                hi = self.edge(i)
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.edge(self.n_buckets - 1)


class MetricsRegistry:
    """Named counters / gauges / histograms, created on first touch.

    Get-or-create and whole-registry reads take ``lock`` so a metrics
    server thread can iterate the families while the engine thread is
    still creating new ones.  Updates to an existing metric are plain
    attribute pokes — atomic enough under the GIL for monitoring reads.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    # -- get-or-create -----------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            with self.lock:
                c = self.counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            with self.lock:
                g = self.gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, **kw) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            with self.lock:
                h = self.histograms.get(name)
                if h is None:
                    h = self.histograms[name] = Histogram(name, **kw)
        return h

    # -- event-style emission ---------------------------------------------
    def inc(self, name: str, n=1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, value) -> None:
        self.gauge(name).set(value)

    def set_max(self, name: str, value) -> None:
        self.gauge(name).set_max(value)

    def observe(self, name: str, value) -> None:
        self.histogram(name).observe(value)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict dump: counter/gauge values, histogram summaries."""
        with self.lock:
            counters = list(self.counters.items())
            gauges = list(self.gauges.items())
            histograms = list(self.histograms.items())
        return {
            "counters": {k: c.value for k, c in counters},
            "gauges": {k: g.value for k, g in gauges},
            "histograms": {
                k: {
                    "count": h.total,
                    "mean": h.mean,
                    "min": h.min,
                    "max": h.max,
                    "p50": h.percentile(50),
                    "p95": h.percentile(95),
                    "p99": h.percentile(99),
                }
                for k, h in histograms
            },
        }
