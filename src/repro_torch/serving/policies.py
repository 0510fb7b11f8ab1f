"""Pluggable engine policies: admission, eviction, defrag, prefix reuse.

Port of ``repro/serving/policies.py``.  Each scheduling decision is a
small object behind a ``Protocol``, so a new serving scenario is a new
policy class, not engine surgery:

* ``AdmissionPolicy`` -- which waiting requests form the next prefill
  *dispatch*.  ``FIFOAdmission`` (the default) admits the FIFO head;
  ``BucketBatchedAdmission`` stacks same-bucket prompts into one batched
  prefill; ``DeadlineAdmission`` also *sheds* requests whose deadline
  expired in queue; ``PriorityAdmission`` ranks by ``Request.priority``
  with aging.
* ``EvictionPolicy`` -- when a running request leaves its lane:
  ``BudgetOrEOSEviction`` (the default, ``Request.done``) or
  ``DeadlinePreemption``.
* ``DefragPolicy`` -- when the paged pool compacts: ``ThresholdDefrag``
  (the default) or ``NeverDefrag``.
* ``PrefixPolicy`` -- how the shared-prefix cache takes part in
  admission.  The port has no prefix cache yet, so only the inert
  ``NoPrefixReuse`` exists; ``PrefixAwareAdmission`` and ``SharedPrefix``
  arrive with it (ROADMAP queue 1, item 6).

Stacking only changes how prefills are dispatched (prefill is
batch-parallel), the default eviction is ``req.done``, and defrag only
moves pages (block tables are remapped in the same step), so the default
policies never change a greedy stream.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Protocol, Sequence, runtime_checkable

from repro_torch.serving.request import Request


@runtime_checkable
class AdmissionPolicy(Protocol):
    def next_group(self, waiting: Sequence[Request], max_group: int,
                   admit_ok: Callable[[Request], bool],
                   bucket_of: Callable[[Request], int]) -> list[int]:
        """Indices into ``waiting`` forming the next admission dispatch.

        ``max_group`` is the engine's cap (free lanes), ``admit_ok`` the
        capacity gate (paged reservations), ``bucket_of`` a request's
        padded prefill length: only same-bucket requests share a dispatch.
        ``[]`` admits nothing this step."""
        ...


@runtime_checkable
class EvictionPolicy(Protocol):
    # True when the decision reads wall time or token values every step
    wants_step_sync: bool

    def should_evict(self, req: Request) -> bool:
        """True when a running request must leave its lane now."""
        ...


@runtime_checkable
class DefragPolicy(Protocol):
    def should_defrag(self, manager) -> bool:
        """True when the paged pool should compact (``manager`` is the
        engine's ``paging.PageManager``)."""
        ...


@runtime_checkable
class PrefixPolicy(Protocol):
    def plan(self, cache, req: Request):
        """The prefix-cache decision for an admission (None = cold)."""
        ...

    def should_publish(self, req: Request) -> bool:
        """Should the request's prompt pages enter the prefix tree?"""
        ...


class FIFOAdmission:
    """Head-of-line FIFO, one request per prefill dispatch.  A vetoed head
    blocks later arrivals on purpose: skipping ahead to smaller requests
    would starve large ones forever."""

    def next_group(self, waiting, max_group, admit_ok, bucket_of):
        if waiting and admit_ok(waiting[0]):
            return [0]
        return []


class BucketBatchedAdmission:
    """The FIFO head plus later waiting requests of the SAME prefill
    bucket, stacked into one batched prefill dispatch.

    Prefill is batch-parallel (each row attends only within itself, and
    right-padding is masked by per-row lengths), so stacking changes the
    dispatch count, not outputs.  The head always admits first; only its
    bucket-mates jump the queue.  ``max_group`` caps the stack (None =
    whatever the engine allows: the free lanes)."""

    def __init__(self, max_group: Optional[int] = None):
        if max_group is not None and max_group < 1:
            raise ValueError("max_group must be >= 1")
        self.max_group = max_group

    def next_group(self, waiting, max_group, admit_ok, bucket_of):
        if not waiting or not admit_ok(waiting[0]):
            return []
        cap = max_group if self.max_group is None else min(max_group, self.max_group)
        head_bucket = bucket_of(waiting[0])
        group = [0]
        for i in range(1, len(waiting)):
            if len(group) >= cap:
                break
            if bucket_of(waiting[i]) == head_bucket and admit_ok(waiting[i]):
                group.append(i)
        return group


class DeadlineAdmission:
    """FIFO admission that sheds already-late requests at ingress.

    A request whose deadline expired in the queue cannot count toward
    goodput however it is served; admitting it burns a prefill and a
    lane.  The engine calls ``shed`` once per step before admission; shed
    requests finish at once with reason ``"deadline"``.  No-deadline
    requests are never shed.  ``slack_s`` also sheds requests with less
    than that much time left."""

    def __init__(self, slack_s: float = 0.0):
        if slack_s < 0.0:
            raise ValueError("slack_s must be >= 0")
        self.slack_s = slack_s

    def next_group(self, waiting, max_group, admit_ok, bucket_of):
        if waiting and admit_ok(waiting[0]):
            return [0]
        return []

    def shed(self, waiting, now: float) -> list[int]:
        """Indices of waiting requests already past their deadline."""
        return [i for i, r in enumerate(waiting)
                if r.deadline_s is not None
                and now - r.submit_time > r.deadline_s - self.slack_s]


class PriorityAdmission:
    """Highest effective priority first, starvation-free through aging.

    A request's effective priority is ``Request.priority`` plus one level
    for every ``aging_steps`` scheduler polls it has waited.  The chosen
    head is head-of-line for the capacity gate, as in FIFO; ties break by
    queue order.  One request per dispatch."""

    def __init__(self, aging_steps: int = 8):
        if aging_steps < 1:
            raise ValueError("aging_steps must be >= 1")
        self.aging_steps = aging_steps
        self._poll = 0
        self._first_poll: dict[int, int] = {}

    def _effective(self, req: Request) -> int:
        waited = self._poll - self._first_poll[req.req_id]
        return req.priority + waited // self.aging_steps

    def next_group(self, waiting, max_group, admit_ok, bucket_of):
        if not waiting:
            return []
        self._poll += 1
        live = set()
        for r in waiting:
            self._first_poll.setdefault(r.req_id, self._poll)
            live.add(r.req_id)
        for rid in [r for r in self._first_poll if r not in live]:
            del self._first_poll[rid]
        head = min(range(len(waiting)), key=lambda i: (-self._effective(waiting[i]), i))
        return [head] if admit_ok(waiting[head]) else []


class BudgetOrEOSEviction:
    """Evict when the request reaches its token budget or emits EOS."""

    wants_step_sync = False

    def should_evict(self, req: Request) -> bool:
        return req.done

    def evict_reason(self, req: Request) -> str:
        if (req.eos_token is not None and req.output_tokens
                and req.output_tokens[-1] == req.eos_token):
            return "eos"
        return "length"


class DeadlinePreemption(BudgetOrEOSEviction):
    """SLO-aware eviction: preempt a lane whose request already missed its
    deadline when a waiting request can still meet its own (no-deadline
    requests always qualify).  With nothing eligible waiting the late
    request keeps running: a late answer beats an idle lane.  Preempted
    requests finish with reason ``"deadline"``.  The deadline check reads
    the engine's decision clock (``bind``)."""

    wants_step_sync = True

    def __init__(self):
        self._clock = time.perf_counter
        self._waiting = lambda: ()

    def bind(self, clock, waiting) -> None:
        """Engine hook (``set_clock``): the decision clock and a live view
        of the waiting queue."""
        self._clock = clock
        self._waiting = waiting

    def should_evict(self, req: Request) -> bool:
        if req.done:
            return True
        if req.deadline_s is None:
            return False
        now = self._clock()
        if now - req.submit_time <= req.deadline_s:
            return False
        return any(w.deadline_s is None or now - w.submit_time <= w.deadline_s
                   for w in self._waiting())

    def evict_reason(self, req: Request) -> str:
        if not req.done:
            return "deadline"
        return super().evict_reason(req)


class NeverDefrag:
    """No automatic compaction."""

    def should_defrag(self, manager) -> bool:
        return False


class ThresholdDefrag:
    """Compact when the pool's fragmentation crosses ``threshold``.

    Fragmentation is ``1 - pages_in_use / span``, ``span`` the highest
    referenced physical page: a compacted pool (pages ``1..pages_in_use``)
    scores 0, holes left by evictions push it toward 1.  ``min_pages``
    keeps a nearly empty pool from churning."""

    def __init__(self, threshold: float = 0.5, min_pages: int = 2):
        if not 0.0 <= threshold < 1.0:
            raise ValueError("threshold must be in [0, 1)")
        self.threshold = threshold
        self.min_pages = min_pages

    def should_defrag(self, manager) -> bool:
        used = manager.pages_in_use
        if used < self.min_pages:
            return False
        span = manager.span
        if span <= 0:
            return False
        return (1.0 - used / span) > self.threshold


class NoPrefixReuse:
    """Prefix policy that matches nothing and publishes nothing."""

    def plan(self, cache, req: Request):
        return None

    def should_publish(self, req: Request) -> bool:
        return False


@dataclasses.dataclass
class EnginePolicies:
    """The engine's decision points.  The defaults are FIFO admission,
    budget-or-EOS eviction and threshold defrag; ``prefix`` only engages
    with a prefix cache (ROADMAP queue 1, item 6)."""

    admission: AdmissionPolicy = dataclasses.field(default_factory=FIFOAdmission)
    eviction: EvictionPolicy = dataclasses.field(default_factory=BudgetOrEOSEviction)
    defrag: DefragPolicy = dataclasses.field(default_factory=ThresholdDefrag)
    prefix: PrefixPolicy = dataclasses.field(default_factory=NoPrefixReuse)
