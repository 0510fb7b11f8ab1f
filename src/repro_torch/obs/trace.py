"""Span-based tracer exporting Chrome trace-event JSON (port of
``repro/obs/trace.py``).

``Tracer.span("decode_step", step=12)`` opens a nested, context-managed
span; closed spans accumulate as Chrome trace *complete events* (``"ph":
"X"``) that ``save()`` writes as a ``{"traceEvents": [...]}`` document —
drop it onto https://ui.perfetto.dev (or ``chrome://tracing``) and the
engine's prefill/chunk/decode/verify/defrag dispatches render as a
timeline.  Timestamps are ``time.perf_counter`` microseconds.

Two properties the serving engine depends on:

* **Async-launch honesty.**  CUDA launches return before the card
  finishes, so a bare span measures *enqueue* time, not device work.  A
  span may register tensors with ``sp.fence(x)``; when the tracer was
  built with ``fence_spans=True`` the span synchronizes the device of
  every fenced CUDA tensor (``torch.cuda.synchronize(device)``) before
  stamping its end, so the span brackets the device computation.  CPU
  tensors need no fence.  With ``fence_spans=False`` the fence call is
  free and **no extra host sync ever happens**.
* **Zero overhead when disabled.**  ``NULL_TRACER`` (a ``NullTracer``)
  hands out one shared no-op span: no event list grows, no timestamps are
  taken, nothing is fenced.  Engine code traces unconditionally and the
  null objects make the disabled path vanish.

Spans nest by call structure: the tracer keeps a stack, stamps each span
with its ``depth``, and Perfetto reconstructs the hierarchy from timestamp
containment on the single engine thread (``tid`` 1).

**Per-lane tracks.**  A span may additionally name the engine lanes
(slots) it covers — ``tracer.span("decode", lanes=running)`` or
``span("prefill", lane=slot)``.  The span still lands on the engine
track, and a copy is emitted per lane at ``tid = slot + 2`` (tid 1 is
the engine stack), with ``thread_name`` metadata so Perfetto renders one
track per lane.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import torch


def _now_us() -> float:
    return time.perf_counter_ns() / 1000.0


def _synchronize(values) -> None:
    """Wait for the devices of the fenced CUDA tensors (each device once);
    CPU tensors and non-tensors are already complete."""
    devices = {v.device for v in values
               if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Span:
    """One in-flight span; use via ``with tracer.span(...) as sp``."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_fences", "_depth",
                 "_lanes")

    def __init__(self, tracer: "Tracer", name: str, args: dict,
                 lanes: tuple = ()):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._fences: list = []
        self._depth = 0
        self._lanes = lanes

    def fence(self, *values) -> None:
        """Register device values the span must wait on before closing
        (only honoured when the tracer fences; otherwise free)."""
        if self._tracer.fence_spans:
            self._fences.extend(values)

    def set(self, **kw) -> None:
        """Attach (or update) span args after entry."""
        self.args.update(kw)

    def __enter__(self) -> "Span":
        self._depth = len(self._tracer._stack)
        self._tracer._stack.append(self)
        self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._fences:
            _synchronize(self._fences)
        t1 = _now_us()
        stack = self._tracer._stack
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._emit(self, t1)
        return False


class _NullSpan:
    """Shared do-nothing span: the disabled tracer's entire hot path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def fence(self, *values) -> None:
        pass

    def set(self, **kw) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans / instants; exports Chrome trace-event JSON."""

    enabled = True

    def __init__(self, fence_spans: bool = False):
        self.fence_spans = fence_spans
        # finished events, already in Chrome trace-event dict form
        self.events: list[dict] = []
        self._stack: list[Span] = []
        self._epoch_us = _now_us()
        self._lane_tids: set = set()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, lanes=None, lane=None, **args) -> Span:
        """Open a span.  ``lanes``/``lane`` name the engine slots the
        dispatch covers; the span is mirrored onto each lane's track."""
        if lane is not None:
            lanes = (lane,)
        return Span(self, name, args,
                    tuple(lanes) if lanes is not None else ())

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (Chrome ``ph: "i"``)."""
        ev = {"name": name, "ph": "i", "ts": _now_us() - self._epoch_us,
              "pid": 1, "tid": 1, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def _emit(self, span: Span, t1_us: float) -> None:
        ev = {
            "name": span.name,
            "ph": "X",
            "ts": span._t0 - self._epoch_us,
            "dur": t1_us - span._t0,
            "pid": 1,
            "tid": 1,
            "cat": "engine",
        }
        args = dict(span.args)
        args["depth"] = span._depth
        ev["args"] = args
        self.events.append(ev)
        # mirror onto per-lane tracks (tid = slot + 2; tid 1 = engine)
        for slot in span._lanes:
            tid = int(slot) + 2
            self._lane_tids.add(tid)
            lane_ev = dict(ev)
            lane_ev["tid"] = tid
            lane_ev["cat"] = "lane"
            lane_ev["args"] = {**args, "lane": int(slot)}
            self.events.append(lane_ev)

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> dict:
        """The full Chrome trace-event document (Perfetto-loadable)."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 1,
             "args": {"name": "repro.serving"}},
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
             "args": {"name": "engine"}},
        ]
        for tid in sorted(self._lane_tids):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": f"lane {tid - 2}"}})
        return {"traceEvents": meta + self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class NullTracer:
    """Disabled tracer: every span is the shared no-op span."""

    enabled = False
    fence_spans = False
    events: tuple = ()

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path: str) -> Optional[str]:
        return None


NULL_TRACER = NullTracer()
