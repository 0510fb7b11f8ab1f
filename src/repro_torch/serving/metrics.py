"""Engine-level serving metrics on the port's ``obs`` registry (port of
``repro/serving/metrics.py``).

Engine code emits events:

    metrics.inc("prefills")            # counters and time accumulators
    metrics.set_gauge("pages_total", n)
    metrics.max_gauge("peak_running", occupancy)
    metrics.observe("ttft_s", t)       # histograms

and ``report()`` derives the summary: the reference's keys, with exact
p50/p95/p99 percentiles of TTFT, per-token decode latency and queue wait
from the registry's histograms, deadline hits and misses, and goodput.
Every counter and gauge reads as an attribute (``metrics.prefills``).
The reference's prefix-cache and speculative-decoding counters, gauges and
keys (``prefix_*``, ``spec_*``, ``verify_dispatches``, ``acceptance_rate``,
``accept_len_*``, ``cost_verify_p99_s``) arrive with those subsystems
(ROADMAP queue 1, item 6).

Wall time: ``begin()`` stamps the start once, every engine step
``touch()``-es the end, and ``record_finished`` advances it, so a run that
finishes nothing still reports its true wall time.
"""

from __future__ import annotations

import time

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.request import Request

# integer event counters
_COUNTERS = (
    "steps", "prefills", "prefill_dispatches", "stacked_prefills",
    "decode_steps", "chunk_steps", "defrag_count", "defrag_pages_moved",
    # SLO accounting: each request's deadline outcome (stamped at finish)
    # and the goodput numerator (no-deadline requests always count; a
    # missed deadline zeroes the request's contribution)
    "deadline_hits", "deadline_misses", "deadline_late_admissions",
    "goodput_tokens",
    # requests shed at ingress by DeadlineAdmission, and running lanes
    # preempted by DeadlinePreemption
    "deadline_shed", "deadline_preempt",
)
# float time accumulators (counters that add seconds)
_TIMERS = ("prefill_s", "decode_s")
# last-value / running-max gauges
_GAUGES = ("peak_running", "pages_total", "page_size", "peak_pages_used",
           "start_time", "end_time")

# request-derived histograms (seconds unless noted)
_HISTOGRAMS = (
    "ttft_s",        # submit -> first sampled token
    "latency_s",     # submit -> finished
    "per_token_s",   # decode only: (latency - ttft) / (n_tokens - 1)
    "queue_wait_s",  # submit -> admitted into a lane
    # per-request cost attribution (from Request.cost, observed at finish)
    "cost_prefill_s", "cost_decode_s", "cost_page_steps",
)


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else 0.0


class EngineMetrics:
    """Accumulated over an engine run; ``report()`` emits the summary."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self.finished: list[Request] = []
        for name in _COUNTERS + _TIMERS:
            self.registry.counter(name)
        for name in _GAUGES:
            self.registry.gauge(name)
        for name in _HISTOGRAMS:
            self.registry.histogram(name)

    def __getattr__(self, name):
        # only reached when ``name`` is not an instance attribute
        reg = self.__dict__.get("registry")
        if reg is None:
            raise AttributeError(name)
        if name in _COUNTERS or name in _TIMERS:
            return reg.counter(name).value
        if name in _GAUGES:
            return reg.gauge(name).value
        raise AttributeError(f"EngineMetrics has no attribute {name!r}")

    # -- emission ------------------------------------------------------------
    def inc(self, name: str, n=1) -> None:
        self.registry.inc(name, n)

    def set_gauge(self, name: str, value) -> None:
        self.registry.set(name, value)

    def max_gauge(self, name: str, value) -> None:
        self.registry.set_max(name, value)

    def observe(self, name: str, value) -> None:
        self.registry.observe(name, value)

    # -- run lifecycle -------------------------------------------------------
    def begin(self) -> None:
        if not self.start_time:
            self.set_gauge("start_time", time.perf_counter())

    def touch(self) -> None:
        """Advance the run's end stamp (every engine step calls this)."""
        self.set_gauge("end_time", time.perf_counter())

    def record_finished(self, req: Request) -> None:
        req.finish_time = time.perf_counter()
        self.set_gauge("end_time", req.finish_time)
        self.finished.append(req)
        if req.ttft_s is not None:
            self.observe("ttft_s", req.ttft_s)
        if req.latency_s is not None:
            self.observe("latency_s", req.latency_s)
            n = len(req.output_tokens)
            if n > 1 and req.ttft_s is not None:
                self.observe("per_token_s", (req.latency_s - req.ttft_s) / (n - 1))
        if req.queue_wait_s is not None:
            self.observe("queue_wait_s", req.queue_wait_s)
        hit = req.deadline_hit
        if hit is not None:
            self.inc("deadline_hits" if hit else "deadline_misses")
            if req.late_at_admission:
                self.inc("deadline_late_admissions")
        if hit is not False:
            self.inc("goodput_tokens", len(req.output_tokens))
        cost = req.cost
        if cost.dispatches:
            self.observe("cost_prefill_s", cost.prefill_s)
            self.observe("cost_decode_s", cost.decode_s)
            if cost.page_steps:
                self.observe("cost_page_steps", cost.page_steps)

    # -- summary -------------------------------------------------------------
    @property
    def wall_s(self) -> float:
        start = self.start_time
        if not start:
            return 0.0
        end = self.end_time or time.perf_counter()
        return max(end - start, 1e-9)

    @property
    def generated_tokens(self) -> int:
        return sum(len(r.output_tokens) for r in self.finished)

    def _pct(self, name: str, q: float, digits: int = 6) -> float:
        return round(self.registry.histogram(name).percentile(q), digits)

    def report(self) -> dict:
        """The reference's summary keys less item 6's (module docstring),
        plus ``decode_step_mean_s`` (unrounded ``decode_s`` over
        ``decode_steps``)."""
        reqs = self.finished
        wall = self.wall_s
        hits, misses = self.deadline_hits, self.deadline_misses
        return {
            "requests": len(reqs),
            "generated_tokens": self.generated_tokens,
            "prompt_tokens": sum(r.prompt_len for r in reqs),
            "wall_s": round(wall, 4),
            "tokens_per_s": round(self.generated_tokens / max(wall, 1e-9), 2),
            "steps": self.steps,
            "prefills": self.prefills,
            "prefill_dispatches": self.prefill_dispatches,
            "stacked_prefills": self.stacked_prefills,
            "decode_steps": self.decode_steps,
            "prefill_s": round(self.prefill_s, 4),
            "decode_s": round(self.decode_s, 4),
            "decode_step_mean_s": (self.decode_s / self.decode_steps
                                   if self.decode_steps else 0.0),
            "ttft_mean_s": round(_mean([r.ttft_s for r in reqs]), 4),
            "ttft_max_s": round(max([r.ttft_s or 0.0 for r in reqs], default=0.0), 4),
            "ttft_p50_s": self._pct("ttft_s", 50),
            "ttft_p95_s": self._pct("ttft_s", 95),
            "ttft_p99_s": self._pct("ttft_s", 99),
            "latency_mean_s": round(_mean([r.latency_s for r in reqs]), 4),
            "latency_max_s": round(max([r.latency_s or 0.0 for r in reqs], default=0.0), 4),
            "per_token_p50_s": self._pct("per_token_s", 50),
            "per_token_p95_s": self._pct("per_token_s", 95),
            "per_token_p99_s": self._pct("per_token_s", 99),
            "queue_wait_p50_s": self._pct("queue_wait_s", 50),
            "queue_wait_p95_s": self._pct("queue_wait_s", 95),
            "queue_wait_p99_s": self._pct("queue_wait_s", 99),
            "peak_running": self.peak_running,
            "chunk_steps": self.chunk_steps,
            "pages_total": self.pages_total,
            "page_size": self.page_size,
            "peak_pages_used": self.peak_pages_used,
            "defrag_count": self.defrag_count,
            "defrag_pages_moved": self.defrag_pages_moved,
            "deadline_hits": hits,
            "deadline_misses": misses,
            "deadline_shed": self.deadline_shed,
            "deadline_preempt": self.deadline_preempt,
            "deadline_hit_rate": round(hits / (hits + misses), 4) if hits + misses else None,
            "goodput_tokens": self.goodput_tokens,
            "goodput_tokens_per_s": round(self.goodput_tokens / max(wall, 1e-9), 2),
            "cost_prefill_p99_s": self._pct("cost_prefill_s", 99),
            "cost_decode_p99_s": self._pct("cost_decode_s", 99),
        }
