"""``ObsConfig``: the frozen, JSON-round-trippable observability surface
(port of ``repro/obs/config.py``: the same fields, defaults and
validation).

One sub-config of ``repro_torch.api.RuntimeConfig`` (the same layering as
``KVConfig``/``SchedulerConfig``): every knob maps onto one field, and
``build()`` turns the config into the live ``Observability`` bundle the
engine consumes.  With everything unset the build returns null sinks —
the zero-overhead disabled mode the hot-path invariant demands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.events import NULL_EVENTS, EventLog
from repro_torch.obs.profile import NULL_PROFILER, StepProfiler
from repro_torch.obs.trace import NULL_TRACER, Tracer


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (all off by default).

    ``enabled=None`` means *auto*: tracing/events turn on iff a sink path
    (or ``debug_invariants``/``fence_spans``) asks for them, so setting
    ``trace="out.json"`` is sufficient.  ``enabled=True`` collects in
    memory even without file sinks (read via ``llm.obs``);
    ``enabled=False`` forces everything off regardless of paths.
    """

    enabled: Optional[bool] = None
    # Chrome trace-event JSON output path (None = don't write a file)
    trace: Optional[str] = None
    # scheduler event-log JSONL output path (None = don't write a file)
    events: Optional[str] = None
    # fence spans (torch.cuda.synchronize) so they bracket device work
    # instead of async launches (serializes the step: measurement mode)
    fence_spans: bool = False
    # torch.profiler: wrap profile_steps engine steps in a device trace
    # written under this directory (None = no profiling)
    profile_dir: Optional[str] = None
    profile_steps: int = 20
    # run PageManager.check_invariants() every engine step and emit a
    # structured violation event (then raise) instead of relying on tests
    debug_invariants: bool = False
    # serve a live /metrics (Prometheus) + /healthz + /snapshot endpoint
    # on this port (0 = ephemeral).  Polls registries only; does not turn
    # the tracer/event sinks on and never touches the dispatch path.
    metrics_port: Optional[int] = None
    # streaming event sink rotation threshold: when the --events JSONL
    # file passes this size it is rotated once to <path>.1
    events_max_mb: float = 64.0
    # numerics watchdog: per-layer saturation/amax/quant-error stats from
    # every quantized GEMM (threaded onto ModelConfig.numerics_watchdog)
    watchdog: bool = False
    # flight recorder: write a replayable bundle (manifest + arrivals +
    # decision journal + outputs + decision-clock tape) into this
    # directory; replay with `python -m repro_torch.launch.replay DIR`.
    # Arming it forces events on — the journal IS the event stream.
    record_path: Optional[str] = None

    def __post_init__(self):
        if self.profile_steps < 1:
            raise ValueError("ObsConfig.profile_steps must be >= 1")
        if self.metrics_port is not None and not (
                0 <= self.metrics_port <= 65535):
            raise ValueError("ObsConfig.metrics_port must be in [0, 65535]")
        if self.events_max_mb <= 0:
            raise ValueError("ObsConfig.events_max_mb must be positive")

    @property
    def resolved_enabled(self) -> bool:
        if self.enabled is not None:
            return self.enabled
        return bool(self.trace or self.events or self.fence_spans
                    or self.debug_invariants or self.record_path)

    def build(self) -> "Observability":
        """The live bundle this config describes (null sinks when off)."""
        on = self.resolved_enabled
        recorder = None
        if self.record_path is not None:
            from repro_torch.obs.recorder import FlightRecorder

            recorder = FlightRecorder(self.record_path)
        if not on:
            events = NULL_EVENTS
        elif recorder is not None:
            # the recorder owns the stream: the decision journal is the
            # event log, written straight into the bundle (an --events
            # sink, if also set, gets the in-memory window via save())
            events = EventLog(stream_path=recorder.journal_path,
                              max_bytes=int(self.events_max_mb * 2 ** 20))
        elif self.events:
            # a file sink streams incrementally with bounded memory
            events = EventLog(stream_path=self.events,
                              max_bytes=int(self.events_max_mb * 2 ** 20))
        else:
            events = EventLog()
        return Observability(
            tracer=Tracer(fence_spans=self.fence_spans) if on else NULL_TRACER,
            events=events,
            profiler=(StepProfiler(self.profile_dir, self.profile_steps)
                      if self.profile_dir else NULL_PROFILER),
            debug_invariants=self.debug_invariants,
            enabled=on,
            config=self,
            recorder=recorder,
        )


@dataclasses.dataclass
class Observability:
    """The engine-facing bundle: tracer + event log + profiler + flags.

    Engine code calls into these unconditionally; the disabled singleton
    (``repro_torch.obs.DISABLED``) makes every call a no-op, which is what keeps
    the invariant 'zero overhead, zero extra host syncs when off' literal
    rather than aspirational.
    """

    tracer: object = NULL_TRACER
    events: object = NULL_EVENTS
    profiler: object = NULL_PROFILER
    debug_invariants: bool = False
    enabled: bool = False
    config: Optional[ObsConfig] = None
    # armed flight recorder (obs.recorder.FlightRecorder) or None;
    # the engine checks `is not None` on host-side request paths only
    recorder: object = None

    def save(self, trace_path: Optional[str] = None,
             events_path: Optional[str] = None) -> list[str]:
        """Write the configured (or explicitly passed) file sinks; returns
        the paths written.  Also flushes a still-armed profiler."""
        self.profiler.close()
        written = []
        tp = trace_path or (self.config.trace if self.config else None)
        ep = events_path or (self.config.events if self.config else None)
        if tp and self.tracer.save(tp):
            written.append(tp)
        if ep and self.events.to_jsonl(ep):
            written.append(ep)
        return written

    def close(self) -> None:
        self.profiler.close()
        self.events.close()
        if self.recorder is not None:
            self.recorder.close()


# the shared disabled bundle: stateless null sinks, safe to share between
# engines (module singleton so the default costs nothing per engine)
DISABLED = Observability()
