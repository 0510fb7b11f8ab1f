"""``torch.profiler`` hooks: wrap N engine steps in a device trace (port of
``repro/obs/profile.py``, which arms ``jax.profiler``).

The span tracer (``obs.trace``) times *dispatches* from the host; what
the card did inside one (kernel times, launches, copies) is
``torch.profiler``'s job.  ``StepProfiler`` arms it over the engine loop:
the first ``step_begin`` after construction starts a profile (CPU
activity always, CUDA activity when the engine's device is a CUDA
device).  That first step is a warm-up, traced and discarded (the
profiler's own ``schedule`` warm-up: the collection is running before
the window opens, so the window's first kernels are not lost); the next
``n_steps`` steps are recorded, then the profile stops, its Chrome trace
is written under ``log_dir`` (``trace_path``) and the profiler goes
inert — so a profiled run captures a bounded window.

On a CUDA engine the card is idle at both ends of the window (each step
is synchronized), and the host waits ``WINDOW_MARGIN_S`` after the window
opens and again before it closes.  The profiler keeps only the kernels
whose device timestamps, mapped onto the host's clock, fall inside the
window; without the margin the window's first launch comes under a
millisecond after it opens and its last kernel ends as close to its end,
so an error of that mapping of a millisecond could drop the first or
last few dozen kernels of the window.  The trace loads in
https://ui.perfetto.dev; ``prof`` keeps the finished
``torch.profiler.profile`` for ``key_averages()``.

Two torch profilers cannot run at once: nothing else may profile while a
``StepProfiler`` is armed.

``NullStepProfiler`` is the disabled twin: both hooks are no-ops, so the
engine calls them unconditionally at zero cost.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

WINDOW_MARGIN_S = 0.05      # the host's idle wait at each end of a CUDA window


class StepProfiler:
    def __init__(self, log_dir: str, n_steps: int = 20):
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        self.log_dir = log_dir
        self.n_steps = n_steps
        self.active = False
        self.done = False
        self.prof: Optional[torch.profiler.profile] = None
        self.trace_path: Optional[str] = None
        self._steps_seen = 0
        self._cuda = None

    def step_begin(self, device=None) -> None:
        """Start the profile at the first step.  ``device``: the engine's
        device; a CUDA device adds CUDA activity (and needs a card)."""
        if self.done or self.active:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device is not None and torch.device(device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("StepProfiler: the engine runs on CUDA but "
                                   "no card is visible")
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._cuda = torch.device(device)
        self.prof = torch.profiler.profile(
            activities=activities, on_trace_ready=self._write,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=self.n_steps,
                                             repeat=1))
        self.prof.start()
        self.active = True

    def step_end(self) -> None:
        if not self.active:
            return
        self._steps_seen += 1
        if self._steps_seen > self.n_steps:      # the warm-up step, then n_steps
            self.close()
            return
        self._sync()
        self.prof.step()
        if self._steps_seen == 1:               # the window has just opened
            self._margin()

    def _sync(self) -> None:
        """Let the step's kernels finish inside the window they belong to."""
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    def _margin(self) -> None:
        """Keep the card idle for ``WINDOW_MARGIN_S`` at an end of a CUDA
        window, so that no kernel lies near that end."""
        if self._cuda is not None:
            time.sleep(WINDOW_MARGIN_S)

    def _write(self, prof) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, f"steps_{os.getpid()}_{self.n_steps}.pt.trace.json")
        prof.export_chrome_trace(self.trace_path)

    def close(self) -> None:
        """Stop the profile if still running, writing the recorded steps
        (idempotent; also the engine's end-of-run hook so short runs flush
        a partial window)."""
        if self.active:
            self._sync()
            self._margin()
            self.prof.stop()
            self.active = False
            self.done = True


class NullStepProfiler:
    """Disabled profiler: hooks are no-ops."""

    active = False
    done = False

    def step_begin(self, device=None) -> None:
        pass

    def step_end(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_PROFILER = NullStepProfiler()
