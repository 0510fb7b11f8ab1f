"""Iteration-level FIFO scheduler (port of ``repro/serving/scheduler.py``
with the default FIFO admission policy).

Each engine step asks once which waiting request to prefill into a free
lane (one batch=1 prefill per step; stacked admission is a later slice);
the head of the queue admits only when the engine's capacity gate
(``admit_ok``: can the page pool reserve its worst case?) lets it — a
vetoed head blocks later arrivals on purpose, so large requests never
starve.  Lanes are handed out lowest-index-first for determinism.
"""

from __future__ import annotations

import heapq
import time
from collections import deque
from typing import Callable, Optional

from repro_torch.serving.request import Request, RequestState


class Scheduler:
    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.waiting: deque[Request] = deque()
        self._free: list[int] = list(range(n_slots))
        heapq.heapify(self._free)
        self.running: dict[int, Request] = {}

    def submit(self, req: Request) -> None:
        if req.state is not RequestState.WAITING:
            raise ValueError(f"request {req.req_id} is {req.state.value}, not waiting")
        self.waiting.append(req)

    def schedule_one(self, admit_ok: Optional[Callable[[Request], bool]] = None
                     ) -> Optional[tuple[Request, int]]:
        """Admit the FIFO head into the lowest free lane, if there is one
        and the gate lets it."""
        if not (self.waiting and self._free):
            return None
        if admit_ok is not None and not admit_ok(self.waiting[0]):
            return None
        req = self.waiting.popleft()
        slot = heapq.heappop(self._free)
        req.state = RequestState.RUNNING
        req.slot = slot
        req.admit_time = time.perf_counter()
        self.running[slot] = req
        return req, slot

    def release(self, slot: int) -> Request:
        """Evict the request in ``slot``; the lane is reusable."""
        req = self.running.pop(slot)
        req.state = RequestState.FINISHED
        req.slot = None
        heapq.heappush(self._free, slot)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
