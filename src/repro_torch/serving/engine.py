"""Continuous-batching serving engine (port of ``repro/serving/engine.py``).

One ``ServingEngine`` owns ``n_slots`` KV-cache lanes and runs an
iteration-level loop.  The cache is one of two stores:

* ``"slot"`` (the default) -- ``slots.SlotCache``: every lane holds
  ``cache_len`` contiguous rows;
* ``"paged"`` -- ``paging.PagedCache``: KV lives in a global page pool,
  each lane's rows found through its block-table row; admission reserves
  a request's worst case, pages materialize as the sequence grows and
  return to the pool the step the request leaves.

Every ``step()``

1. **sheds** waiting requests whose deadline already passed, when the
   admission policy sheds (``DeadlineAdmission``);
2. **admits**, up to ``max_prefills_per_step`` dispatches: in-flight
   chunked admissions continue first, then the admission policy forms one
   dispatch at a time through the capacity gate.  A dispatch is a batch=1
   prefill padded to the smallest prefill bucket, a stacked prefill of
   several same-bucket prompts (``BucketBatchedAdmission``), or, in paged
   mode for prompts longer than ``prefill_chunk``, the first
   page-aligned chunk of a **chunked prefill** whose later chunks ride the
   following steps, so a long prompt no longer stalls the running
   decodes.  The last prefill row's logits give the first token;
3. **decodes** one token for every running lane in one ``decode_step``
   over the whole store, with the ``active`` mask pinning the others;
4. **evicts** lanes the eviction policy releases (budget or EOS; or a
   missed deadline under ``DeadlinePreemption``), the same step;
5. **defrags** the paged pool when the defrag policy says so: pages move
   to the lowest physical indices and the block tables follow, so no
   token changes.

WHICH requests admit, WHEN a lane leaves and WHEN the pool compacts are
``policies.EnginePolicies``.  Tokens reach the host every step (the
reference defers the pull while no scheduling decision needs it; the
streams are the same).  Scheduling is output-invisible: each request's
greedy stream is its solo ``serve_batch`` stream.

Not ported yet, and refused with ``NotImplementedError``: the prefix cache
and speculative decoding (ROADMAP queue 1, item 6), observability and the
flight recorder (item 8) and device meshes (item 10).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (
    DEFAULT_PAGE_SIZE,
    KV_CACHE_HEADROOM,
    ModelConfig,
    pages_for,
)
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.paging import PagedCache, chunkable_with_state, make_chunk_step, paged_insert_many
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.policies import EnginePolicies
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import SamplingParams, greedy_tokens
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.slots import SlotCache, scatter_lanes


def _roundup(n: int, m: int) -> int:
    return pages_for(n, m) * m


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape/policy knobs (model behaviour stays in ``ModelConfig``)."""

    n_slots: int = 4
    cache_len: int = 256
    max_prefills_per_step: int = 1
    # prompts pad up to the smallest bucket >= len(prompt); None/() = exact
    prefill_buckets: Optional[tuple[int, ...]] = None
    eos_token: Optional[int] = None
    # "slot" (per-lane cache_len rows) | "paged" (global page pool)
    cache_mode: str = "slot"
    page_size: int = DEFAULT_PAGE_SIZE
    # pool size in pages; None = the slot-equivalent KV budget
    n_pages: Optional[int] = None
    # paged mode: prompts longer than this admit in page-aligned chunks of
    # this many tokens, interleaved with decode steps; None = one shot.
    # Must be a multiple of page_size.
    prefill_chunk: Optional[int] = None
    # options of the reference engine that later slices port
    prefix_cache: bool = False
    spec: Optional[object] = None


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 device=None, policies: Optional[EnginePolicies] = None, obs=None,
                 mesh=None):
        ecfg = engine_cfg
        if ecfg.cache_mode not in ("slot", "paged"):
            raise ValueError(f"cache_mode must be 'slot' or 'paged', got "
                             f"{ecfg.cache_mode!r}")
        for hit, what, item in ((ecfg.prefix_cache, "prefix_cache", "6"),
                                (ecfg.spec is not None, "spec (speculative decoding)", "6"),
                                (obs is not None, "obs (observability)", "8"),
                                (mesh is not None, "mesh (sharded serving)", "10")):
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP queue 1, item {item})")
        buckets = tuple(sorted(ecfg.prefill_buckets or ()))
        if buckets and buckets[-1] > ecfg.cache_len:
            raise ValueError("largest prefill bucket exceeds cache_len")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.engine_cfg = ecfg
        self.buckets = buckets
        self.paged = ecfg.cache_mode == "paged"
        self.policies = policies if policies is not None else EnginePolicies()
        n = ecfg.n_slots
        self.scheduler = Scheduler(n, ecfg.max_prefills_per_step,
                                   admission=self.policies.admission)
        self.metrics = EngineMetrics()
        self.set_clock(time.perf_counter)
        self._chunk_len = ecfg.prefill_chunk
        self._chunk_fn = None
        if self.paged:
            ps = ecfg.page_size
            if self._chunk_len is not None:
                if self._chunk_len % ps:
                    raise ValueError("prefill_chunk must be a multiple of page_size "
                                     "(chunks are page-aligned)")
                if not chunkable_with_state(cfg):
                    raise ValueError(f"{cfg.name}: chunked prefill needs row-independent "
                                     "kinds; use prefill_chunk=None")
                self._chunk_fn = make_chunk_step(cfg, self._chunk_len)
            self.store = PagedCache(cfg, n, ecfg.cache_len, ps, ecfg.n_pages,
                                    device=self.device)
            self.metrics.set_gauge("pages_total", self.store.n_pages)
            self.metrics.set_gauge("page_size", ps)
        else:
            if self._chunk_len is not None:
                raise ValueError("chunked prefill requires cache_mode='paged'")
            self.store = SlotCache(cfg, n, ecfg.cache_len, device=self.device)
        # each lane's next decode input (the token it sampled last)
        self._tokens = torch.zeros((n,), dtype=torch.int32, device=self.device)
        self._next_id = 0
        self._step_idx = 0

    # ------------------------------------------------------------------
    # Decision clock
    # ------------------------------------------------------------------
    def set_clock(self, clock) -> None:
        """Install the decision clock: every time reading that can change
        a scheduling decision (submit stamps, admission lateness, deadline
        shedding and preemption) goes through it, so a test can script
        it.  Metric timestamps (TTFT, latency, dispatch timers) stay on
        ``time.perf_counter``."""
        self._clock = clock
        self.scheduler.clock = clock
        if hasattr(self.policies.eviction, "bind"):
            self.policies.eviction.bind(clock, lambda: self.scheduler.waiting)

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def add_request(self, prompt: Sequence[int], max_new_tokens: int,
                    sampling: Optional[SamplingParams] = None,
                    eos_token: Optional[int] = None, on_token=None, on_text=None,
                    detokenizer=None, priority: int = 0,
                    deadline_s: Optional[float] = None) -> Request:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = len(prompt) + max_new_tokens
        if need > self.engine_cfg.cache_len + 1:
            raise ValueError(
                f"request needs {need} cache positions but cache_len="
                f"{self.engine_cfg.cache_len}; size the engine with "
                f"default_cache_len(prompt_len, gen) [headroom={KV_CACHE_HEADROOM}]")
        if self.paged:
            # a request the pool can never reserve would block the queue
            pages = pages_for(self._worst_case_rows(len(prompt), max_new_tokens),
                              self.engine_cfg.page_size)
            usable = self.store.n_pages - 1  # page 0 is the trash page
            if pages > usable:
                raise ValueError(f"request reserves {pages} pages but the pool only "
                                 f"has {usable} usable pages; raise n_pages")
        sampling = sampling or SamplingParams()
        req = Request(
            req_id=self._next_id, prompt=prompt, max_new_tokens=max_new_tokens,
            sampling=sampling,
            eos_token=self.engine_cfg.eos_token if eos_token is None else eos_token,
            on_token=on_token, on_text=on_text, detokenizer=detokenizer,
            priority=priority,
            deadline_s=sampling.deadline_s if deadline_s is None else deadline_s,
            submit_time=self._clock())
        self._next_id += 1
        self.scheduler.submit(req)
        return req

    def _bucket_len(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        return prompt_len

    def _single_len(self, padded_len: int) -> int:
        """Rows a paged admission prefill allocates: the bucket rounded up
        to whole pages."""
        return _roundup(padded_len, self.engine_cfg.page_size)

    def _should_chunk_len(self, prompt_len: int) -> bool:
        c = self._chunk_len
        if not self.paged or c is None or prompt_len <= c:
            return False
        # the padded final chunk must stay inside the lane's block table
        return _roundup(prompt_len, c) <= self.store.max_pages * self.engine_cfg.page_size

    def _admit_rows(self, prompt_len: int) -> int:
        """Cache rows the admission itself touches (chunk padding or the
        page-rounded prefill bucket)."""
        if self._should_chunk_len(prompt_len):
            return _roundup(prompt_len, self._chunk_len)
        return self._single_len(self._bucket_len(prompt_len))

    def _worst_case_rows(self, prompt_len: int, max_new_tokens: int) -> int:
        """Rows a request reserves: its admission footprint or prompt +
        budget, whichever is larger, capped at the block-table width."""
        worst = max(self._admit_rows(prompt_len), prompt_len + max_new_tokens)
        return min(worst, self.store.max_pages * self.engine_cfg.page_size)

    def _reserve_tokens(self, req: Request) -> int:
        return self._worst_case_rows(req.prompt_len, req.max_new_tokens)

    def _admit_gate(self):
        """Capacity gate for one admission dispatch.  It tallies every
        member's reservation against one pool snapshot, so two requests
        that do not fit together never both pass."""
        if not self.paged:
            return lambda req: True
        tally = [0]

        def gate(req: Request) -> bool:
            mgr = self.store.manager
            need = mgr.pages_for(self._reserve_tokens(req))
            if need <= mgr.available - tally[0]:
                tally[0] += need
                return True
            return False

        return gate

    def _admit_bucket(self, req: Request) -> int:
        """Bucket key for stacked admission.  Chunked admissions are
        single-file (one chunk stream per lane): each gets a sentinel no
        other request matches."""
        if self._should_chunk_len(req.prompt_len):
            return -(req.req_id + 1)
        return self._bucket_len(req.prompt_len)

    def _arm_lane(self, req: Request, slot: int, tok: int) -> None:
        """First token sampled: it is the lane's next decode input."""
        req.append_token(tok)   # stamps TTFT
        self.metrics.inc("prefills")
        self._tokens[slot] = tok

    def _paged_reserve(self, req: Request, slot: int, single_len: int) -> list[int]:
        """Reserve a paged admission's worst case and take its prefill's
        pages; returns the page ids."""
        mgr = self.store.manager
        mgr.admit(slot, self._reserve_tokens(req))
        page_ids = mgr.alloc(slot, single_len // self.engine_cfg.page_size)
        mgr.set_length(slot, req.prompt_len)
        return page_ids

    def _prefill_rows(self, reqs: list[Request], padded: int, cache_len: int):
        """Batched prefill of right-padded prompts: (greedy first tokens on
        the host, contiguous cache of ``cache_len`` rows)."""
        tokens = torch.zeros((len(reqs), padded), dtype=torch.int32)
        for i, req in enumerate(reqs):
            tokens[i, :req.prompt_len] = torch.tensor(req.prompt, dtype=torch.int32)
        lengths = torch.tensor([r.prompt_len for r in reqs], dtype=torch.int32,
                               device=self.device)
        logits, cache = model_lib.prefill(self.params, self.cfg, tokens.to(self.device),
                                          cache_len, lengths=lengths)
        return greedy_tokens(logits), cache

    def _admit_group(self, group: list[tuple[Request, int]]) -> None:
        """One admission dispatch: the group's same-bucket prompts (one, or
        several when stacked) prefill as one batch whose rows go to their
        lanes (pages in paged mode, after reserving each member's worst
        case); the logits give each request its first token.  Every member
        passed the tallied gate against one pool snapshot, so the
        reservations cannot overcommit.  Prefill is batch-parallel, so a
        stacked row is the solo prefill's row."""
        reqs = [req for req, _ in group]
        slots = [slot for _, slot in group]
        padded = self._bucket_len(reqs[0].prompt_len)
        t0 = time.perf_counter()
        if self.paged:
            single_len = self._single_len(padded)
            page_ids = [self._paged_reserve(req, slot, single_len) for req, slot in group]
            table_rows = [self.store.manager.block_tables[slot] for slot in slots]
            toks, multi = self._prefill_rows(reqs, padded, single_len)
            paged_insert_many(self.store.cache, multi, slots, page_ids, table_rows,
                              [r.prompt_len for r in reqs])
        else:
            toks, multi = self._prefill_rows(reqs, padded, self.engine_cfg.cache_len)
            scatter_lanes(self.store.cache, multi, slots, self.store._axes)
        toks = toks.cpu().tolist()
        share = (time.perf_counter() - t0) / len(group)
        self.metrics.inc("prefill_dispatches")
        if len(group) > 1:
            self.metrics.inc("stacked_prefills", len(group))
        for req, slot, tok in zip(reqs, slots, toks):
            req.cost.prefill_s += share
            req.cost.dispatches += 1
            self._arm_lane(req, slot, tok)

    # -- chunked prefill -------------------------------------------------
    def _begin_chunked(self, req: Request, slot: int, finished: list[Request]) -> None:
        self.store.manager.admit(slot, self._reserve_tokens(req))
        self.scheduler.begin_chunked(slot)
        req.prefill_done = 0
        self._process_chunk(req, slot, finished)

    def _process_chunk(self, req: Request, slot: int, finished: list[Request]) -> None:
        """Feed one page-aligned prompt chunk; the final chunk gives the
        first token and moves the lane into the decode batch."""
        mgr = self.store.manager
        c = self._chunk_len
        start = req.prefill_done
        n = min(c, req.prompt_len - start)
        mgr.ensure(slot, start + c)   # the padded tail lands in pages too
        self.store.sync_tables()
        tokens = torch.zeros((1, c), dtype=torch.int32)
        tokens[0, :n] = torch.tensor(req.prompt[start:start + n], dtype=torch.int32)
        t0 = time.perf_counter()
        logits = self._chunk_fn(self.params, self.store.cache, tokens.to(self.device), slot,
                                start, n)
        req.prefill_done = start + n
        last = req.prefill_done >= req.prompt_len
        first = int(greedy_tokens(logits)[0]) if last else None   # host pull
        req.cost.prefill_s += time.perf_counter() - t0
        req.cost.dispatches += 1
        self.metrics.inc("chunk_steps")
        self.metrics.inc("prefill_dispatches")
        if not last:
            return
        mgr.set_length(slot, req.prompt_len)
        self.scheduler.promote(slot)
        self._arm_lane(req, slot, first)
        if self._should_evict(req):  # max_new_tokens == 1 (or instant EOS)
            self._evict(slot, finished)

    # ------------------------------------------------------------------
    # The engine loop
    # ------------------------------------------------------------------
    def step(self) -> list[Request]:
        """One scheduler iteration: admissions (or prompt chunks), then one
        batched decode over the running lanes, then defrag.  Returns the
        requests finished this step."""
        m = self.metrics
        m.begin()
        self._step_idx += 1
        m.inc("steps")
        finished: list[Request] = []
        self._shed_late(finished)
        budget = self.scheduler.max_prefills_per_step

        t0 = time.perf_counter()
        did_prefill = False
        # in-flight chunked admissions continue first
        for slot, req in sorted(self.scheduler.chunking.items()):
            if budget <= 0:
                break
            self._process_chunk(req, slot, finished)
            budget -= 1
            did_prefill = True
        # then one admission dispatch at a time through the capacity gate
        while budget > 0:
            group = self.scheduler.schedule_group(
                admit_ok=self._admit_gate(), bucket_of=self._admit_bucket,
                max_group=self.scheduler.free_slots)
            if not group:
                break
            budget -= 1
            did_prefill = True
            if self._should_chunk_len(group[0][0].prompt_len):   # chunked ones come alone
                self._begin_chunked(*group[0], finished)
                continue
            self._admit_group(group)
            for req, slot in group:
                if self._should_evict(req):  # max_new_tokens == 1 (or instant EOS)
                    self._evict(slot, finished)
        if did_prefill:
            _sync(self.device)
            m.inc("prefill_s", time.perf_counter() - t0)

        running = self.scheduler.running
        m.max_gauge("peak_running", len(running) + len(self.scheduler.chunking))
        if running:
            t0 = time.perf_counter()
            if self.paged:
                mgr = self.store.manager
                for slot, req in running.items():
                    mgr.ensure(slot, int(mgr.lengths[slot]) + 1)
                    req.cost.page_steps += len(mgr.lane_pages[slot])
                self.store.sync_tables()
                m.max_gauge("peak_pages_used", mgr.pages_in_use)
            active = np.zeros((self.engine_cfg.n_slots,), bool)
            active[list(running)] = True
            logits, _ = model_lib.decode_step(
                self.params, self.cfg, self._tokens, self.store.cache,
                active=torch.from_numpy(active).to(self.device))
            self._tokens = greedy_tokens(logits)
            if self.paged:
                mgr.advance(running)
            toks = self._tokens.cpu().numpy()
            decoded = list(running.items())
            for slot, req in decoded:
                req.append_token(int(toks[slot]))
            for slot, req in decoded:
                if self._should_evict(req):
                    self._evict(slot, finished)
            m.inc("decode_steps")
            dt = time.perf_counter() - t0
            m.inc("decode_s", dt)
            for _, req in decoded:
                req.cost.decode_s += dt / len(decoded)
                req.cost.dispatches += 1

        # evictions may have left holes in the pool: compact before the
        # next admissions when the defrag policy says so
        if self.paged and self.policies.defrag.should_defrag(self.store.manager):
            moves = self.store.defrag()
            if moves:
                m.inc("defrag_count")
                m.inc("defrag_pages_moved", len(moves))
        m.touch()
        return finished

    def _shed_late(self, finished: list[Request]) -> None:
        """Deadline pre-pass: a waiting request already past its deadline
        can only produce dead tokens, so it is shed before it costs a
        prefill and a lane.  Only admission policies with ``shed``
        (``DeadlineAdmission``) trigger this."""
        shed = getattr(self.policies.admission, "shed", None)
        if shed is None or not self.scheduler.waiting:
            return
        idxs = shed(self.scheduler.waiting, self._clock())
        if not idxs:
            return
        for req in self.scheduler.drop(idxs):
            req.finish_reason_override = "deadline"
            self.metrics.inc("deadline_shed")
            self.metrics.record_finished(req)
            finished.append(req)

    def _should_evict(self, req: Request) -> bool:
        return self.policies.eviction.should_evict(req)

    def _evict(self, slot: int, finished: list[Request]) -> None:
        req = self.scheduler.release(slot)
        self.store.free(slot)
        reason_of = getattr(self.policies.eviction, "evict_reason", None)
        if reason_of is not None and reason_of(req) == "deadline" and not req.done:
            # DeadlinePreemption took the lane back from a request that
            # already missed its deadline, for queued work that still can
            req.finish_reason_override = "deadline"
            self.metrics.inc("deadline_preempt")
        self.metrics.record_finished(req)
        finished.append(req)

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def run(self, arrivals=None, max_steps: int = 100_000) -> EngineMetrics:
        """Drive steps until idle.  ``arrivals``: ``(step_idx, prompt,
        max_new_tokens[, SamplingParams])`` tuples injected when the engine
        reaches that step."""
        pending = sorted(arrivals or [], key=lambda a: a[0])
        i = 0
        steps = 0
        while (i < len(pending) or self.has_work) and steps < max_steps:
            while i < len(pending) and pending[i][0] <= self._step_idx:
                arr = pending[i]
                self.add_request(arr[1], arr[2],
                                 sampling=arr[3] if len(arr) > 3 else None)
                i += 1
            if not self.has_work:
                self._step_idx = pending[i][0]  # idle gap: jump to the arrival
                continue
            self.step()
            steps += 1
        return self.metrics
