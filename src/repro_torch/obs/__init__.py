"""``repro_torch.obs`` — tracing, metrics and profiling for the port's
serving stack (port of ``repro/obs/``).

* ``trace``   — nested spans over engine dispatches (prefill / chunk /
  decode / verify / defrag), optionally fenced with
  ``torch.cuda.synchronize`` so they measure device work, exported as
  Chrome trace-event JSON (Perfetto-loadable), with per-lane tracks.
* ``metrics`` — counters, gauges and log-bucketed histograms with exact
  percentile queries and Prometheus labels; ``serving.EngineMetrics`` is
  built on it.
* ``events``  — the structured scheduler event log: every admit / reject /
  evict / CoW-fork / defrag / spec-fallback decision with its reason and
  a monotonic ``seq``, reassembled per request as a
  queued→admitted→chunks→first-token→finished timeline (surfaced on
  ``api.RequestOutput``); streams to JSONL with one rotation.
* ``profile`` — ``torch.profiler`` over N engine steps (CUDA activity on
  the card), written as a Chrome trace.
* ``config``  — ``ObsConfig`` (the ``RuntimeConfig.obs`` layer) and the
  ``Observability`` bundle the engine consumes; ``DISABLED`` is the
  shared null bundle.
* ``server``  — Prometheus text exposition over ``MetricsRegistry``
  (series named as the reference's, ``repro_*``), a grammar validator, and
  the stdlib ``MetricsServer`` serving ``/metrics``, ``/healthz``,
  ``/snapshot`` and ``/events`` on 127.0.0.1 from a daemon thread.
* ``recorder`` / ``replay`` — the flight recorder: arm with
  ``ObsConfig(record_path=DIR)`` to capture a run (config fingerprint,
  arrival schedule, decision journal, token outputs, decision-clock
  tape) into a bundle that ``replay_bundle`` / ``LLM.replay`` /
  ``python -m repro_torch.launch.replay`` reproduces bitwise, diffing a
  divergence to the first bad decision.  The bundle format is the
  reference's.  (``obs.replay`` imports the api layer, so it is imported
  lazily, not re-exported here.)
* ``watchdog`` — the numerics watchdog: per-layer saturation / amax /
  quant-error / accumulator-headroom stats from every quantized GEMM,
  staged on the device and copied to the host once per model call (off:
  nothing computed; on: outputs bitwise unchanged).

Two invariants: disabled observability adds **zero overhead** (null
sinks, no extra host syncs on the decode path), and enabled
observability is **output-invisible** (greedy token streams stay bitwise
identical with tracing, fencing and the watchdog on).
"""

from repro_torch.obs import watchdog
from repro_torch.obs.config import DISABLED, Observability, ObsConfig
from repro_torch.obs.events import NULL_EVENTS, EventLog, NullEventLog
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     labeled, split_labels)
from repro_torch.obs.profile import NULL_PROFILER, NullStepProfiler, StepProfiler
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.server import MetricsServer, render_exposition, validate_exposition
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Counter",
    "DISABLED",
    "EventLog",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "NULL_EVENTS",
    "NULL_PROFILER",
    "NULL_TRACER",
    "NullEventLog",
    "NullStepProfiler",
    "NullTracer",
    "ObsConfig",
    "Observability",
    "Span",
    "StepProfiler",
    "Tracer",
    "labeled",
    "render_exposition",
    "split_labels",
    "validate_exposition",
    "watchdog",
]
