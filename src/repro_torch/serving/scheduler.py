"""Iteration-level scheduler (port of ``repro/serving/scheduler.py``).

Each engine step asks the scheduler which waiting requests to prefill
into free lanes this iteration; every occupied lane takes one batched
decode step.  WHICH requests admit, and whether several share one stacked
prefill dispatch, is an ``policies.AdmissionPolicy``'s decision; the
scheduler owns the mechanical state: the queue, the free lanes and the
running / chunking maps.  The engine bounds the dispatches of one step by
``max_prefills_per_step``, so a burst of arrivals cannot starve running
decodes.

* ``admit_ok`` is the engine's capacity gate in paged mode: a request
  admits only when the page pool can reserve its worst case.
* A chunked admission holds its lane in the ``chunking`` state while the
  engine feeds it prompt chunks between decode steps (``begin_chunked``
  / ``promote``); chunking lanes sit out the decode batch.

Lanes are handed out lowest-index-first, so a workload always gets the
same lane assignment.
"""

from __future__ import annotations

import heapq
import time
import warnings
from collections import deque
from typing import Callable, Optional

from repro_torch.serving.policies import AdmissionPolicy, FIFOAdmission
from repro_torch.serving.request import Request, RequestState


class Scheduler:
    def __init__(self, n_slots: int, max_prefills_per_step: int = 1,
                 admission: Optional[AdmissionPolicy] = None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_prefills_per_step = max(1, max_prefills_per_step)
        self.admission = admission if admission is not None else FIFOAdmission()
        self.waiting: deque[Request] = deque()
        self._free: list[int] = list(range(n_slots))
        heapq.heapify(self._free)
        self.running: dict[int, Request] = {}
        self.chunking: dict[int, Request] = {}
        # the decision clock: admission stamps and deadline checks read it
        # (``ServingEngine.set_clock`` swaps it)
        self.clock: Callable[[], float] = time.perf_counter

    def submit(self, req: Request) -> None:
        if req.state is not RequestState.WAITING:
            raise ValueError(f"request {req.req_id} is {req.state.value}, not waiting")
        self.waiting.append(req)

    def schedule_group(self, admit_ok: Optional[Callable[[Request], bool]] = None,
                       bucket_of: Optional[Callable[[Request], int]] = None,
                       max_group: int = 1) -> list[tuple[Request, int]]:
        """The admission policy's next prefill dispatch: one or more waiting
        requests (same bucket when stacked) admitted into free lanes
        together.  Returns (request, lane) pairs in queue order, lowest
        free lane first."""
        if not self.waiting or not self._free:
            return []
        idxs = self.admission.next_group(
            self.waiting, max(1, min(max_group, len(self._free))),
            admit_ok or (lambda r: True), bucket_of or (lambda r: r.prompt_len))
        if not idxs:
            return []
        idxs = sorted(set(idxs))
        reqs = [self.waiting[i] for i in idxs]
        for i in reversed(idxs):
            del self.waiting[i]
        out = []
        now = self.clock()
        for req in reqs:
            slot = heapq.heappop(self._free)
            req.state = RequestState.RUNNING
            req.slot = slot
            req.admit_time = now
            if req.deadline_s is not None and now - req.submit_time > req.deadline_s:
                # the deadline passed in queue: this lane cannot add goodput
                req.late_at_admission = True
            self.running[slot] = req
            out.append((req, slot))
        return out

    def drop(self, idxs: list[int]) -> list[Request]:
        """Remove waiting requests by index (deadline shedding); they
        finish without ever holding a lane.  Returns them in queue order."""
        idxs = sorted(set(idxs))
        dropped = [self.waiting[i] for i in idxs]
        for i in reversed(idxs):
            del self.waiting[i]
        for req in dropped:
            req.state = RequestState.FINISHED
        return dropped

    def request_in(self, slot: int) -> Optional[Request]:
        """The request holding ``slot`` (decoding or mid-chunked-prefill)."""
        return self.running.get(slot) or self.chunking.get(slot)

    def begin_chunked(self, slot: int) -> Request:
        """Move a just-admitted request into the chunked-prefill state."""
        req = self.running.pop(slot)
        req.state = RequestState.PREFILLING
        self.chunking[slot] = req
        return req

    def promote(self, slot: int) -> Request:
        """Final chunk done: the lane joins the decode batch."""
        req = self.chunking.pop(slot)
        req.state = RequestState.RUNNING
        self.running[slot] = req
        return req

    def release(self, slot: int) -> Request:
        """Evict the request in ``slot``; the lane is reusable."""
        req = self.running.pop(slot)
        req.state = RequestState.FINISHED
        req.slot = None
        heapq.heappush(self._free, slot)
        return req

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.chunking)


class FIFOScheduler(Scheduler):
    """Deprecated name for ``Scheduler`` with the default FIFO admission
    policy (the reference keeps it for callers from before ``api``)."""

    def __init__(self, n_slots: int, max_prefills_per_step: int = 1):
        warnings.warn(
            "FIFOScheduler is deprecated; use Scheduler (optionally with an "
            "explicit policies.AdmissionPolicy)", DeprecationWarning,
            stacklevel=2)
        super().__init__(n_slots, max_prefills_per_step, admission=FIFOAdmission())
