"""Observability of the port: the metrics primitives the engine's
``serving.metrics.EngineMetrics`` sits on.  Tracing, events, the metrics
server and the flight recorder are ROADMAP queue 1, item 8."""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
