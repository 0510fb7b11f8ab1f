"""Metrics primitives: counters, gauges, log-bucketed histograms.

The port's own copy of ``repro/obs/metrics.py`` (jax-free there too, but
the port imports nothing of the reference).  Engine code *emits*
(``inc`` / ``set`` / ``observe``) and summaries are *derived*
(``serving.metrics.EngineMetrics.report``).

``Histogram`` buckets observations geometrically (``base * growth**i``
edges), the usual shape for latencies that span orders of magnitude, and
keeps the raw observations beside the bucket counts: a serving run
observes one value per request or per step, so percentiles
(``p50/p95/p99``) are exact, numpy-style interpolation.  Labelled series,
snapshots and the lock a scrape thread needs belong to the metrics server
(ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import math
from typing import Optional


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
    open-ended.  The defaults cover 1 microsecond .. ~3.9 hours."""

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

    def edge(self, i: int) -> float:
        """Inclusive upper edge of bucket ``i``."""
        return self.base * self.growth ** i

    def bucket_index(self, value: float) -> int:
        if value <= self.base:
            return 0
        i = 1 + math.floor(math.log(value / self.base, self.growth))
        # float log can land either side of an edge: settle on the true
        # (inclusive upper) edges
        while i > 0 and value <= self.edge(i - 1):
            i -= 1
        while value > self.edge(i) and i < self.n_buckets - 1:
            i += 1
        return min(i, self.n_buckets - 1)

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
        """Exact q-th percentile (linear interpolation, numpy-style); 0.0
        when nothing was observed."""
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


class MetricsRegistry:
    """Named counters / gauges / histograms, created on first touch."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(name)
        return self.counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self.gauges:
            self.gauges[name] = Gauge(name)
        return self.gauges[name]

    def histogram(self, name: str, **kw) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram(name, **kw)
        return self.histograms[name]

    def inc(self, name: str, n=1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, value) -> None:
        self.gauge(name).set(value)

    def set_max(self, name: str, value) -> None:
        self.gauge(name).set_max(value)

    def observe(self, name: str, value) -> None:
        self.histogram(name).observe(value)
