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
   over the whole store, with the ``active`` mask pinning the others,
   sampling per lane (greedy / temperature / top-k, ``sampling.py``) --
   or, with ``spec`` set and every running lane greedy, one draft-verify
   round (``repro_torch/spec/``) that may emit several tokens a lane;
4. **evicts** lanes the eviction policy releases (budget or EOS; or a
   missed deadline under ``DeadlinePreemption``), the same step;
5. **defrags** the paged pool when the defrag policy says so: pages move
   to the lowest physical indices and the block tables follow, so no
   token changes.

WHICH requests admit, WHEN a lane leaves, WHEN the pool compacts and
HOW cached prefixes are reused are ``policies.EnginePolicies``.  Tokens
reach the host every step (the reference defers the pull while no
scheduling decision needs it; the streams are the same).  Scheduling is
output-invisible: each request's greedy stream is its solo
``serve_batch`` stream.

With ``EngineConfig.prefix_cache`` (paged) admissions consult the
shared-prefix radix tree (``repro_torch/prefix/``): the longest
page-aligned cached prefix is aliased into the lane's block table
(refcounted pages, copy-on-write on the boundary page for full-prompt
hits) and only the uncached suffix runs through the chunk step; completed
prefills publish their full pages, and the tree LRU-evicts under pool
pressure inside the admission gate.  On int8 pools every admission goes
through the chunk step, so cold and warm runs attend the same dequantized
pages.  Greedy streams with the cache on are the cache-off streams.

With ``EngineConfig.spec`` (an enabled ``SpecConfig``) each all-greedy
decode becomes a draft-verify round: the drafter proposes up to ``k``
tokens a lane, one ``verify_step`` scores the window, the accepted prefix
plus one token is emitted, and rejected rows roll back by length.  A batch
with a stochastic lane decodes plainly that step.

Observability (``obs=``, an ``obs.Observability``; ``DISABLED`` by
default) sees every dispatch and decision, in the reference's order and
with its fields: spans (``step``, ``prefill``, ``prefill_stacked``,
``chunk``, ``decode``, ``verify``, ``defrag``; fenced with
``fence_spans``), the scheduler event log (queued, admitted, rejected,
chunk, first_token, cow_fork, prefix_evict, spec_fallback, spec_verify,
defrag, evicted, finished), the step profiler, page-pool invariant
checks every step (``debug_invariants``), and the flight recorder's
hooks (the decision clock's tape, arrivals, outputs).  Disabled, every
hook is a null object's no-op.

Sharded serving (``mesh=``, a ``launch.mesh.Mesh``) is SPMD: every rank
builds the same engine, takes the same requests and runs the same host
scheduler and ``PageManager``; it holds its part of the params
(``shard.shard_params``) and of the KV (its KV heads of every page, as
``shard.pool_shardings`` gives them), and runs the rank's config
(``shard.local_config``) inside ``runtime.collectives.model_parallel``.
Block tables stay on the host, the same on every rank.  The logits every
rank samples are gathered, so they are the same bytes on every rank, and
every rank samples the same tokens (a verify round: the same targets and
accept lengths) with no collective of its own; ``debug_invariants``
checks every step that the ranks' next tokens are model-axis rank 0's.
A draft model runs unsharded on every rank.  Every decoder-only arch
serves so: MLA, the recurrent cells and the local-attention ring hold
their rank's blocks of the reference's cache specs (``models/kvcache.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (
    DEFAULT_PAGE_SIZE,
    KV_CACHE_HEADROOM,
    ModelConfig,
    default_cache_len,
    pages_for,
)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as model_lib
from repro_torch.models.kvcache import PAGED_KINDS, is_paged_kind  # noqa: F401
from repro_torch.models.transformer import RECURRENT_KINDS
from repro_torch.obs import DISABLED, Observability
from repro_torch.paging import (
    PagedCache,
    chunkable,
    chunkable_with_state,
    make_chunk_step,
    paged_insert_many,
    stack_kinds,
)
from repro_torch.prefix import PrefixCache
from repro_torch.runtime.collectives import axis as mesh_axis
from repro_torch.runtime.collectives import broadcast, model_parallel
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.policies import EnginePolicies
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import SamplingParams, greedy_tokens, request_key, sample_tokens
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.slots import SlotCache, scatter_lanes
from repro_torch.shard.core import local_config
from repro_torch.spec import make_drafter, verify
from repro_torch.spec.config import SpecConfig


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
    # paged mode: shared-prefix KV cache (repro_torch/prefix/) -- admissions
    # alias the longest page-aligned cached prefix and prefill only the
    # uncached suffix, through the chunk step
    prefix_cache: bool = False
    # speculative decoding (repro_torch/spec/): draft k tokens a lane and
    # verify them in one dispatch.  None / enabled=False = plain decode
    spec: Optional[SpecConfig] = None

    @staticmethod
    def for_workload(prompt_len: int, gen_tokens: int, n_slots: int = 4,
                     **kw) -> "EngineConfig":
        """Cache sized by the shared serving policy (prompt + gen + headroom)."""
        return EngineConfig(n_slots=n_slots,
                            cache_len=default_cache_len(prompt_len, gen_tokens), **kw)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 device=None, policies: Optional[EnginePolicies] = None,
                 obs: Optional[Observability] = None, mesh=None):
        ecfg = engine_cfg
        if cfg.is_encoder_decoder or cfg.frontend is not None:
            raise ValueError(
                "ServingEngine handles decoder-only token-input models; "
                "encoder-decoder and frontend archs serve via api.serve_batch")
        if ecfg.cache_mode not in ("slot", "paged"):
            raise ValueError(f"cache_mode must be 'slot' or 'paged', got "
                             f"{ecfg.cache_mode!r}")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh (see "
                            f"shard.build_mesh), got {type(mesh).__name__}")
        self.mesh = mesh
        tp = mesh.shape.get("model", 1) if mesh is not None else 1
        # the model axis the sampled tokens are agreed over (None: unsharded)
        self._axis = mesh_axis(mesh, "model") if tp > 1 else None
        self.model_cfg = cfg
        cfg = local_config(cfg, tp)
        buckets = tuple(sorted(ecfg.prefill_buckets or ()))
        recurrent = sorted(RECURRENT_KINDS & set(cfg.block_pattern))
        if buckets and recurrent:
            raise ValueError(
                f"prefill buckets pad prompts, but {recurrent} state integrates padded "
                "tokens; use exact-length prefill (prefill_buckets=None) for recurrent "
                "stacks")
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
        # observability: the DISABLED bundle's null sinks make every
        # tracer / event / profiler call below a no-op
        self.obs = obs if obs is not None else DISABLED
        n = ecfg.n_slots
        self.scheduler = Scheduler(n, ecfg.max_prefills_per_step,
                                   admission=self.policies.admission)
        self.metrics = EngineMetrics()
        # flight recorder: None when disarmed.  Armed, the decision clock
        # tapes every reading so a replay can script time-dependent
        # decisions (deadline sheds and preemptions) back
        self._recorder = getattr(self.obs, "recorder", None)
        self.set_clock(self._recorder.wrap_clock()
                       if self._recorder is not None else time.perf_counter)
        if self._recorder is not None:
            self._recorder.record_engine(ecfg)
        # whole-stack effective kinds: the local-attention rings and the
        # recurrent states stay per lane in both cache modes, so a stack of
        # only those reserves no pages
        kinds = stack_kinds(cfg)
        self._has_ring = "local_attn" in kinds and cfg.sliding_window is not None
        self._has_paged_kinds = any(is_paged_kind(k, cfg) for k in kinds)
        # chunk length for both long-prompt chunking and the prefix cache's
        # suffix prefill (one page a chunk when prefill_chunk is unset)
        self._chunk_len = ecfg.prefill_chunk
        self._chunk_fn = None
        self.prefix: Optional[PrefixCache] = None
        if self.paged:
            ps = ecfg.page_size
            if self._has_ring and ecfg.cache_len % ps:
                raise ValueError(
                    "paged serving of local-attention stacks needs cache_len to be a "
                    "multiple of page_size (the per-lane ring insert must match the "
                    "pool's ring length)")
            if self._chunk_len is not None:
                if self._chunk_len % ps:
                    raise ValueError("prefill_chunk must be a multiple of page_size "
                                     "(chunks are page-aligned)")
                if not chunkable_with_state(cfg):
                    raise ValueError(
                        f"{cfg.name}: chunked prefill needs row-independent kinds "
                        "(attn/MLA/dense) or state-carrying recurrent cells "
                        "(rglru/mlstm/slstm); use prefill_chunk=None")
            if ecfg.prefix_cache:
                if not self._has_paged_kinds:
                    raise ValueError(
                        f"{cfg.name}: prefix_cache needs attention-family KV pages to "
                        "share; this stack keeps all state per-lane")
                if not chunkable(cfg):
                    raise ValueError(
                        f"{cfg.name}: prefix_cache resumes the uncached suffix through "
                        "the chunked-prefill step, which needs a strictly "
                        "row-independent stack (attn/MLA/dense); "
                        f"got {sorted(stack_kinds(cfg))}")
            self.store = PagedCache(cfg, n, ecfg.cache_len, ps, ecfg.n_pages,
                                    device=self.device)
            self.metrics.set_gauge("pages_total", self.store.n_pages)
            self.metrics.set_gauge("page_size", ps)
            if ecfg.prefix_cache:
                self._chunk_len = ecfg.prefill_chunk or ps
                # full-prompt hits CoW-fork the boundary page and resume at
                # the final prompt token -- int8 pools included: every
                # admission on an int8 + prefix pool goes through the chunk
                # step (``_should_chunk_len``), so cold and warm runs attend
                # the same dequantized pages
                self.prefix = PrefixCache(self.store.manager, ps, allow_fork=True)
            if self._chunk_len is not None:
                self._chunk_fn = make_chunk_step(cfg, self._chunk_len)
        else:
            if self._chunk_len is not None:
                raise ValueError("chunked prefill requires cache_mode='paged'")
            if ecfg.prefix_cache:
                raise ValueError("prefix_cache requires cache_mode='paged' "
                                 "(shared pages live in the page pool)")
            self.store = SlotCache(cfg, n, ecfg.cache_len, device=self.device)

        # speculative decoding: the k-token verify window reuses the
        # chunked prefill's row-independence contract
        spec = ecfg.spec
        self._spec = spec if (spec is not None and spec.enabled) else None
        self._drafter = None
        if self._spec is not None:
            if not chunkable(cfg):
                raise ValueError(
                    f"{cfg.name}: speculative decoding needs a stack of strictly "
                    "row-independent kinds (attn/MLA/dense) — the k-token verify "
                    "window reuses the chunked-prefill contract; "
                    f"got {sorted(stack_kinds(cfg))}")
            self._drafter = make_drafter(
                self._spec, self.model_cfg, n, ecfg.cache_len,
                tree=self.prefix.tree if self.prefix is not None else None,
                device=self.device)

        # prefix-aware admission orders the queue by adopted-page signature;
        # the policy is engine-agnostic, so the engine hands it the lookup
        if hasattr(self.policies.admission, "bind"):
            self.policies.admission.bind(self._admission_prefix_sig)

        # per-lane state: the next decode input (the token sampled last) on
        # the device, the sampling policy on the host
        self._tokens = torch.zeros((n,), dtype=torch.int32, device=self.device)
        self._temps = np.ones((n,), np.float32)
        self._topk = np.zeros((n,), np.int32)
        self._greedy = np.ones((n,), bool)
        # per-request memoized prefix plans: req_id -> (tree epoch, plan)
        self._plan_cache: dict[int, tuple] = {}
        self._next_id = 0
        self._step_idx = 0

    # ------------------------------------------------------------------
    # Decision clock
    # ------------------------------------------------------------------
    def set_clock(self, clock) -> None:
        """Install the decision clock: every time reading that can change
        a scheduling decision (submit stamps, admission lateness, deadline
        shedding and preemption) goes through it.  Recording wraps
        ``time.perf_counter`` to tape each reading; replay installs a
        ``ReplayClock`` that scripts the tape back.  Metric timestamps
        (TTFT, latency, dispatch timers) stay on ``time.perf_counter``."""
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
        # speculative decoding writes up to k rows past the accepted
        # position (the verify window's overshoot), so the budget check and
        # the paged reservations carry the extra rows
        need = len(prompt) + max_new_tokens + self._spec_overshoot
        if need > self.engine_cfg.cache_len + 1:
            raise ValueError(
                f"request needs {need} cache positions but cache_len="
                f"{self.engine_cfg.cache_len}; size the engine with "
                f"default_cache_len(prompt_len, gen) [headroom={KV_CACHE_HEADROOM}]")
        if self.paged and self._has_paged_kinds:
            # a request the pool can never reserve would block the queue
            pages = pages_for(self._worst_case_rows(len(prompt), max_new_tokens),
                              self.engine_cfg.page_size)
            usable = self.store.n_pages - 1  # page 0 is the trash page
            if pages > usable:
                raise ValueError(f"request reserves {pages} pages but the pool only "
                                 f"has {usable} usable pages; raise n_pages")
        sampling = sampling or SamplingParams()
        if deadline_s is None:
            deadline_s = sampling.deadline_s
        req = Request(
            req_id=self._next_id, prompt=prompt, max_new_tokens=max_new_tokens,
            sampling=sampling,
            eos_token=self.engine_cfg.eos_token if eos_token is None else eos_token,
            on_token=on_token, on_text=on_text, detokenizer=detokenizer,
            priority=priority, deadline_s=deadline_s, submit_time=self._clock())
        self._next_id += 1
        self.scheduler.submit(req)
        self.obs.events.emit("queued", req.req_id, prompt_len=req.prompt_len,
                             max_new_tokens=max_new_tokens, priority=priority,
                             **({"deadline_s": deadline_s} if deadline_s is not None else {}))
        if self._recorder is not None:
            self._recorder.record_arrival(req, self._step_idx)
        return req

    def _bucket_len(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        return prompt_len

    def _single_len(self, padded_len: int) -> int:
        """Rows a paged admission prefill allocates: the bucket rounded up
        to whole pages -- except for local-attention ring stacks, whose ring
        must be the pool's (``cache_len`` is page-aligned there)."""
        if self._has_ring:
            return self.engine_cfg.cache_len
        return _roundup(padded_len, self.engine_cfg.page_size)

    def _should_chunk_len(self, prompt_len: int) -> bool:
        c = self.engine_cfg.prefill_chunk
        # int8 pools attend dequantized pages on the chunk path but raw bf16
        # K/V on the one-shot prefill path: with the prefix cache EVERY
        # admission goes through the chunk step, so cold and warm runs are
        # the same computation
        force = self.prefix is not None and self.cfg.kv_cache_dtype == "int8"
        if force:
            c = self._chunk_len
        if not self.paged or c is None or (prompt_len <= c and not force):
            return False
        # the padded final chunk must stay inside the lane's block table
        return _roundup(prompt_len, c) <= self.store.max_pages * self.engine_cfg.page_size

    @property
    def _spec_overshoot(self) -> int:
        """Extra cache rows the verify window may write past the accepted
        position (rejected drafts' K/V, overwritten next step)."""
        return self._spec.k if self._spec is not None else 0

    def _admit_rows(self, prompt_len: int) -> int:
        """Cache rows the admission itself touches (chunk padding or the
        page-rounded prefill bucket)."""
        if self._should_chunk_len(prompt_len):
            return _roundup(prompt_len, self._chunk_len)
        return self._single_len(self._bucket_len(prompt_len))

    def _worst_case_rows(self, prompt_len: int, max_new_tokens: int) -> int:
        """Rows a request reserves: its admission footprint or prompt +
        budget (+ the speculative overshoot), whichever is larger, capped at
        the block-table width."""
        worst = max(self._admit_rows(prompt_len),
                    prompt_len + max_new_tokens + self._spec_overshoot)
        return min(worst, self.store.max_pages * self.engine_cfg.page_size)

    def _reserve_tokens(self, req: Request) -> int:
        return self._worst_case_rows(req.prompt_len, req.max_new_tokens)

    # -- shared-prefix planning -----------------------------------------
    def _prefix_rows(self, req: Request, plan) -> int:
        """Rows a prefix-seeded lane reserves: the suffix-chunk footprint
        (resume + whole chunks, the padded tail included) or prompt +
        budget (+ overshoot), whichever is larger."""
        suffix = plan.resume + _roundup(req.prompt_len - plan.resume, self._chunk_len)
        return max(suffix, req.prompt_len + req.max_new_tokens + self._spec_overshoot)

    def _prefix_plan(self, req: Request):
        """The admission's prefix decision (None = admit cold).  A plan
        whose reservation could never fit a lane's block table falls back
        to the cold path, which ``add_request`` already validated.
        Memoized per (request, tree epoch): the bucket key, the capacity
        gate and the dispatch consult the same plan in one round, and the
        tree is re-walked only after a structural change."""
        if self.prefix is None:
            return None
        hit = self._plan_cache.get(req.req_id)
        if hit is not None and hit[0] == self.prefix.epoch:
            return hit[1]
        plan = self.policies.prefix.plan(self.prefix, req)
        if plan is not None:
            pages = pages_for(self._prefix_rows(req, plan), self.engine_cfg.page_size)
            if pages > self.store.max_pages or pages > self.store.n_pages - 1:
                plan = None
        self._plan_cache[req.req_id] = (self.prefix.epoch, plan)
        return plan

    def _prefix_draw(self, req: Request, plan) -> int:
        """Pages a prefix-seeded admission draws from the free pool."""
        pages = pages_for(self._prefix_rows(req, plan), self.engine_cfg.page_size)
        return pages - len(plan.pages) + (1 if plan.fork_index is not None else 0)

    def _admission_prefix_sig(self, req: Request):
        """Adopted-page signature for prefix-aware admission ordering (None
        = cold admission)."""
        plan = self._prefix_plan(req)
        return tuple(plan.pages) if plan is not None else None

    def _admit_gate(self):
        """Capacity gate for one admission dispatch.  It tallies every
        member's reservation against one pool snapshot, so two requests
        that do not fit together never both pass.  A cached prefix
        discounts the draw, and under pressure the prefix tree LRU-evicts
        pages no lane uses (never pages a candidate of this dispatch is
        about to adopt)."""
        if not (self.paged and self._has_paged_kinds):
            return lambda req: True
        tally = [0]
        protected: list = []

        def gate(req: Request) -> bool:
            mgr = self.store.manager
            plan = self._prefix_plan(req)
            if plan is None:
                need = mgr.pages_for(self._reserve_tokens(req))
            else:
                need = self._prefix_draw(req, plan)
                protected.extend(plan.nodes)
            deficit = need - (mgr.available - tally[0])
            # evict only when it can close the gap: a request that does not
            # fit even with an empty tree must not drain the cache for nothing
            if (deficit > 0 and self.prefix is not None
                    and deficit <= self.prefix.evictable_pages):
                freed = self.prefix.evict_for(deficit, protect=protected)
                if freed:
                    self.metrics.inc("prefix_evicted_pages", freed)
                    self.metrics.set_gauge("prefix_tree_pages", self.prefix.cached_pages)
                    self.obs.events.emit("prefix_evict", pages=freed, deficit=int(deficit))
            if need <= mgr.available - tally[0]:
                tally[0] += need
                return True
            self.obs.events.emit("rejected", req.req_id, reason="page_capacity",
                                 need_pages=int(need),
                                 available=int(mgr.available - tally[0]))
            return False

        return gate

    def _admit_bucket(self, req: Request) -> int:
        """Bucket key for stacked admission.  Chunked and prefix-seeded
        admissions are single-file (one chunk stream per lane): each gets
        a sentinel no other request matches."""
        if self.paged and (self._should_chunk_len(req.prompt_len)
                           or self._prefix_plan(req) is not None):
            return -(req.req_id + 1)
        return self._bucket_len(req.prompt_len)

    # -- sampling --------------------------------------------------------
    def _lane_key(self, req: Request) -> int:
        """The lane's sampling key for its next token (0 for greedy)."""
        if req.sampling.greedy:
            return 0
        return request_key(req.sampling.seed, req.req_id, len(req.output_tokens))

    def _sample(self, logits, reqs: list[Request]) -> torch.Tensor:
        """An admission's first tokens: one per logits row, row i sampled
        by ``reqs[i]``'s policy and key.  All-greedy rows take the argmax
        alone."""
        if all(r.sampling.greedy for r in reqs):
            return greedy_tokens(logits)
        return sample_tokens(logits, [r.sampling.temperature for r in reqs],
                             [r.sampling.top_k for r in reqs],
                             [r.sampling.greedy for r in reqs],
                             [self._lane_key(r) for r in reqs])

    def _arm_lane(self, req: Request, slot: int, tok: int) -> None:
        """First token sampled: it is the lane's next decode input."""
        s = req.sampling
        self._plan_cache.pop(req.req_id, None)   # admitted: the plan is consumed
        req.append_token(tok)   # stamps TTFT
        self.metrics.inc("prefills")
        self.obs.events.emit("first_token", req.req_id, slot=slot, ttft_s=req.ttft_s)
        if self._drafter is not None:
            with model_parallel(None):      # the draft model is not sharded
                self._drafter.admit(slot, req.prompt)
        self._tokens[slot] = tok
        self._temps[slot] = s.temperature
        self._topk[slot] = s.top_k
        self._greedy[slot] = s.greedy

    # -- shared-prefix bookkeeping ---------------------------------------
    def _record_miss(self) -> None:
        if self.prefix is not None:
            self.metrics.inc("prefix_misses")

    def _maybe_publish(self, req: Request, slot: int) -> None:
        """After a prefill completes, enter the prompt's full pages into the
        prefix tree.  Only prefill-written rows publish, never
        decode-written ones, whose computation differs."""
        if self.prefix is None or not self.policies.prefix.should_publish(req):
            return
        self.prefix.publish(req.prompt, self.store.manager.lane_pages[slot])
        self.metrics.set_gauge("prefix_tree_pages", self.prefix.cached_pages)

    def _cow(self, slot: int, move) -> None:
        """Apply a copy-on-write fork on the device (``move`` = (src, dst))."""
        self.store.copy_pages([move[0]], [move[1]])
        self.metrics.inc("prefix_cow_forks")
        req = self.scheduler.request_in(slot)
        self.obs.events.emit("cow_fork", req.req_id if req is not None else None,
                             slot=slot, src=int(move[0]), dst=int(move[1]))

    def _paged_reserve(self, req: Request, slot: int, single_len: int) -> list[int]:
        """Reserve a paged admission's worst case and take its prefill's
        pages; returns the page ids (none for a stack that keeps all its
        state per lane)."""
        mgr = self.store.manager
        if not self._has_paged_kinds:
            mgr.admit(slot, 0)
            mgr.set_length(slot, req.prompt_len)
            return []
        mgr.admit(slot, self._reserve_tokens(req))
        page_ids = mgr.alloc(slot, single_len // self.engine_cfg.page_size)
        mgr.set_length(slot, req.prompt_len)
        return page_ids

    def _prefill_rows(self, reqs: list[Request], padded: int, cache_len: int):
        """Batched prefill of right-padded prompts: (first tokens, sampled
        per request, contiguous cache of ``cache_len`` rows)."""
        tokens = torch.zeros((len(reqs), padded), dtype=torch.int32)
        for i, req in enumerate(reqs):
            tokens[i, :req.prompt_len] = torch.tensor(req.prompt, dtype=torch.int32)
        lengths = torch.tensor([r.prompt_len for r in reqs], dtype=torch.int32,
                               device=self.device)
        logits, cache = model_lib.prefill(self.params, self.cfg,
                                          {"tokens": tokens.to(self.device)},
                                          cache_len, lengths=lengths)
        return self._sample(logits, reqs), cache

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
        k = len(group)
        padded = self._bucket_len(reqs[0].prompt_len)
        page_ids = None
        if self.paged:
            # reserve before the admitted events, so they journal the pages
            single_len = self._single_len(padded)
            page_ids = [self._paged_reserve(req, slot, single_len) for req, slot in group]
        for i, (req, slot) in enumerate(group):
            self.obs.events.emit(
                "admitted", req.req_id, slot=slot,
                **({"mode": "cold"} if k == 1 else {"mode": "stacked", "group": k}),
                **({"pages": [int(p) for p in page_ids[i]]} if self.paged else {}),
                queue_wait_s=req.queue_wait_s)
        span = (self.obs.tracer.span("prefill", lane=slots[0], req=reqs[0].req_id,
                                     slot=slots[0], tokens=padded) if k == 1 else
                self.obs.tracer.span("prefill_stacked", lanes=slots, k=k, tokens=padded))
        t0 = time.perf_counter()
        with span as sp:
            if self.paged:
                table_rows = [self.store.manager.block_tables[slot] for slot in slots]
                toks, multi = self._prefill_rows(reqs, padded, single_len)
                paged_insert_many(self.store.cache, multi, slots, page_ids, table_rows,
                                  [r.prompt_len for r in reqs])
            else:
                toks, multi = self._prefill_rows(reqs, padded, self.engine_cfg.cache_len)
                scatter_lanes(self.store.cache, multi, slots, self.store._axes)
            sp.fence(toks)
        toks = toks.cpu().tolist()
        share = (time.perf_counter() - t0) / len(group)
        self.metrics.inc("prefill_dispatches")
        if len(group) > 1:
            self.metrics.inc("stacked_prefills", len(group))
        for req, slot, tok in zip(reqs, slots, toks):
            req.cost.prefill_s += share
            req.cost.dispatches += 1
            if self.paged:
                self._record_miss()
                self._maybe_publish(req, slot)
            self._arm_lane(req, slot, tok)

    # -- chunked prefill -------------------------------------------------
    def _begin_chunked(self, req: Request, slot: int, finished: list[Request]) -> None:
        # a stack that keeps all its state per lane reserves no pages, or
        # the pool gate would veto admissions that touch no pool rows
        reserved = self._reserve_tokens(req) if self._has_paged_kinds else 0
        self.store.manager.admit(slot, reserved)
        self.obs.events.emit("admitted", req.req_id, slot=slot, mode="chunked",
                             reserved=int(reserved), queue_wait_s=req.queue_wait_s)
        self.scheduler.begin_chunked(slot)
        req.prefill_done = 0
        self._record_miss()
        self._process_chunk(req, slot, finished)

    def _begin_prefix(self, req: Request, slot: int, plan, finished: list[Request]) -> None:
        """Prefix-seeded admission: alias the cached pages into the lane's
        block table, CoW-fork the boundary page if the plan resumes inside
        one (full-prompt hit), then stream only the uncached suffix through
        the chunk step -- a fully cached prompt recomputes a single token."""
        mgr = self.store.manager
        mgr.admit(slot, self._prefix_rows(req, plan), adopt_pages=plan.pages,
                  forks=0 if plan.fork_index is None else 1)
        self.obs.events.emit("admitted", req.req_id, slot=slot, mode="prefix",
                             cached_tokens=plan.resume, cached_pages=len(plan.pages),
                             pages=[int(p) for p in plan.pages],
                             fork=plan.fork_index is not None,
                             fork_index=plan.fork_index, queue_wait_s=req.queue_wait_s)
        if plan.fork_index is not None:
            self._cow(slot, mgr.cow_fork(slot, plan.fork_index))
        self.prefix.tree.touch(plan.nodes)
        self.metrics.inc("prefix_hits")
        self.metrics.inc("prefix_hit_tokens", plan.resume)
        self.scheduler.begin_chunked(slot)
        req.prefill_done = plan.resume
        self._process_chunk(req, slot, finished)

    def _process_chunk(self, req: Request, slot: int, finished: list[Request]) -> None:
        """Feed one prompt chunk; the final chunk gives the first token and
        moves the lane into the decode batch.  Chunks are page-aligned
        except a prefix plan's first one, which may start mid-page right
        after a CoW fork."""
        mgr = self.store.manager
        c = self._chunk_len
        start = req.prefill_done
        n = min(c, req.prompt_len - start)
        if self.prefix is not None:
            # CoW guard: the write range never touches a shared page (the
            # planned fork already privatized the only candidate; this keeps
            # the invariant literal)
            move = mgr.ensure_writable(slot, start)
            if move is not None:
                self._cow(slot, move)
        if self._has_paged_kinds:
            mgr.ensure(slot, start + c)   # the padded tail lands in pages too
        self.store.sync_tables()
        tokens = torch.zeros((1, c), dtype=torch.int32)
        tokens[0, :n] = torch.tensor(req.prompt[start:start + n], dtype=torch.int32)
        t0 = time.perf_counter()
        with self.obs.tracer.span("chunk", lane=slot, req=req.req_id, slot=slot,
                                  start=start, n=n) as sp:
            logits = self._chunk_fn(self.params, self.store.cache, tokens.to(self.device),
                                    slot, start, n)
            sp.fence(logits)
        req.prefill_done = start + n
        last = req.prefill_done >= req.prompt_len
        first = int(self._sample(logits, [req])[0]) if last else None   # host pull
        req.cost.prefill_s += time.perf_counter() - t0
        req.cost.dispatches += 1
        self.metrics.inc("chunk_steps")
        self.metrics.inc("prefill_dispatches")
        self.obs.events.emit("chunk", req.req_id, slot=slot, start=start, n=n, done=last)
        if not last:
            return
        mgr.set_length(slot, req.prompt_len)
        self.scheduler.promote(slot)
        self._maybe_publish(req, slot)
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
        obs = self.obs
        obs.profiler.step_begin(self.device)
        with obs.tracer.span("step", idx=self._step_idx + 1), model_parallel(self.mesh):
            finished = self._step_inner()
        obs.profiler.step_end()
        if obs.debug_invariants and self.paged and self._has_paged_kinds:
            bad = self.store.manager.invariant_violations()
            if bad:
                obs.events.emit("invariant_violation", step=self._step_idx,
                                violations=bad)
                raise AssertionError(f"page-pool invariants violated at step "
                                     f"{self._step_idx}: " + "; ".join(bad))
        if obs.debug_invariants and self._axis is not None and \
                not torch.equal(broadcast(self._tokens, self._axis, 0), self._tokens):
            raise AssertionError(f"model-axis ranks sampled different tokens at step "
                                 f"{self._step_idx}")
        self.metrics.touch()
        return finished

    def _step_inner(self) -> list[Request]:
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
            if len(group) == 1:    # chunked and prefix-seeded admissions come alone
                req, slot = group[0]
                plan = self._prefix_plan(req) if self.paged else None
                if plan is not None:
                    self._begin_prefix(req, slot, plan, finished)
                    continue
                if self._should_chunk_len(req.prompt_len):
                    self._begin_chunked(req, slot, finished)
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
        if running and self._spec is not None and self._spec_ready():
            t0 = time.perf_counter()
            spec_reqs = list(running.values())
            self._spec_decode(finished)
            dt = time.perf_counter() - t0
            m.inc("decode_s", dt)
            for req in spec_reqs:
                req.cost.verify_s += dt / len(spec_reqs)
                req.cost.dispatches += 1
        elif running:
            if self._spec is not None:
                # spec is configured but a non-greedy lane keeps this batch
                # from speculating: the round decodes plainly
                self.obs.events.emit("spec_fallback", reason="non_greedy_lane",
                                     batch=len(running))
            t0 = time.perf_counter()
            if self.paged and self._has_paged_kinds:
                mgr = self.store.manager
                for slot, req in running.items():
                    row = int(mgr.lengths[slot])
                    if self.prefix is not None:
                        # a lane's first write into a shared page forks it
                        # (the admission fork already covers this; the guard
                        # keeps the invariant unconditional)
                        move = mgr.ensure_writable(slot, row)
                        if move is not None:
                            self._cow(slot, move)
                    mgr.ensure(slot, row + 1)
                    req.cost.page_steps += len(mgr.lane_pages[slot])
                self.store.sync_tables()
                m.max_gauge("peak_pages_used", mgr.pages_in_use)
            active = np.zeros((self.engine_cfg.n_slots,), bool)
            active[list(running)] = True
            with self.obs.tracer.span("decode", lanes=list(running),
                                      batch=len(running)) as sp:
                logits, _ = model_lib.decode_step(
                    self.params, self.cfg, self._tokens, self.store.cache,
                    active=torch.from_numpy(active).to(self.device))
                if self._greedy.all():
                    self._tokens = greedy_tokens(logits)
                else:
                    keys = [self._lane_key(running[s]) if s in running else 0
                            for s in range(self.engine_cfg.n_slots)]
                    self._tokens = sample_tokens(logits, self._temps, self._topk,
                                                 self._greedy, keys)
                sp.fence(self._tokens)
            if self.paged:
                self.store.manager.advance(running)
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
        if (self.paged and self._has_paged_kinds
                and self.policies.defrag.should_defrag(self.store.manager)):
            with self.obs.tracer.span("defrag") as sp:
                moves = self.store.defrag()
                sp.set(pages_moved=len(moves))
            if moves:
                m.inc("defrag_count")
                m.inc("defrag_pages_moved", len(moves))
                self.obs.events.emit("defrag", pages_moved=len(moves),
                                     moves=[[int(s), int(d)] for s, d in moves],
                                     step=self._step_idx)
        return finished

    # ------------------------------------------------------------------
    # Speculative decoding (repro_torch/spec/)
    # ------------------------------------------------------------------
    def _spec_ready(self) -> bool:
        """Speculate only when every running lane is greedy: the accept rule
        is exact for argmax; a mixed batch decodes plainly this step."""
        return all(r.sampling.greedy for r in self.scheduler.running.values())

    def _spec_decode(self, finished: list[Request]) -> None:
        """One draft-verify round over every running lane.  The window is
        always ``k + 1`` wide; per-lane draft counts and acceptance lengths
        are data (``n_draft``, the accept rule), never shapes."""
        spec = self._spec
        running = dict(self.scheduler.running)
        n, w = self.engine_cfg.n_slots, spec.width
        slots = sorted(running)
        histories = [running[s].prompt + running[s].output_tokens for s in slots]
        with model_parallel(None):
            proposals = self._drafter.propose(slots, histories)

        toks = np.zeros((n, w), np.int32)
        n_draft = np.zeros((n,), np.int32)
        active = np.zeros((n,), bool)
        for slot, hist, props in zip(slots, histories, proposals):
            req = running[slot]
            # never draft past the lane's budget: the verify row for draft j
            # emits token j+1, so at most budget-1 drafts
            allow = max(0, min(spec.k, req.max_new_tokens - len(req.output_tokens) - 1))
            props = [int(t) for t in props[:allow]]
            toks[slot, 0] = hist[-1]
            toks[slot, 1:1 + len(props)] = props
            n_draft[slot] = len(props)
            active[slot] = True
            self.metrics.inc("spec_proposed", len(props))

        base_row = {}
        if self.paged:
            mgr = self.store.manager
            for slot in slots:
                row = int(mgr.lengths[slot])
                base_row[slot] = row
                if self.prefix is not None:
                    # the whole verify window must be privately writable
                    for move in mgr.ensure_writable_range(slot, row, w):
                        self._cow(slot, move)
                mgr.ensure(slot, row + w)
                running[slot].cost.page_steps += len(mgr.lane_pages[slot])
            self.store.sync_tables()
            self.metrics.max_gauge("peak_pages_used", mgr.pages_in_use)

        dev = self.device
        with self.obs.tracer.span("verify", batch=len(slots), width=w, lanes=slots) as sp:
            _, targets, accepted = verify(
                self.params, self.cfg, self.store.cache, torch.from_numpy(toks).to(dev),
                torch.from_numpy(n_draft).to(dev), torch.from_numpy(active).to(dev))
            sp.fence(targets, accepted)
        self.metrics.inc("verify_dispatches")
        self.metrics.inc("decode_steps")
        targets = targets.cpu().numpy()
        accepted = accepted.cpu().numpy()
        # journal the round's operands before the accept loop's evictions
        self.obs.events.emit("spec_verify", lanes=[int(s) for s in slots],
                             n_draft=[int(n_draft[s]) for s in slots],
                             accepted=[int(accepted[s]) for s in slots])

        feed = self._tokens.cpu()
        for slot in slots:
            req = running[slot]
            a = int(accepted[slot])
            # emit the accepted drafts + the bonus/correction row, stopping
            # at EOS / budget exactly like the plain-decode loop
            emitted = 0
            for j in range(a + 1):
                req.append_token(int(targets[slot, j]))
                emitted += 1
                if self._should_evict(req):
                    break
            self.metrics.inc("spec_accepted", min(emitted, a))
            self.metrics.observe("accept_len", min(emitted, a))
            if self.paged:
                # rollback = length truncate: rejected rows' pages stay
                # reserved to the lane and are overwritten in place
                self.store.manager.set_length(slot, base_row[slot] + emitted)
            feed[slot] = req.output_tokens[-1]
            if self._should_evict(req):
                self._evict(slot, finished)
        self._tokens = feed.to(dev)

    def _shed_late(self, finished: list[Request]) -> None:
        """Deadline pre-pass: a waiting request already past its deadline
        can only produce dead tokens, so it is shed before it costs a
        prefill and a lane.  Only admission policies with ``shed``
        (``DeadlineAdmission``) trigger this."""
        shed = getattr(self.policies.admission, "shed", None)
        if shed is None or not self.scheduler.waiting:
            return
        now = self._clock()
        idxs = shed(self.scheduler.waiting, now)
        if not idxs:
            return
        for req in self.scheduler.drop(idxs):
            req.finish_reason_override = "deadline"
            self._plan_cache.pop(req.req_id, None)
            self.metrics.inc("deadline_shed")
            self.metrics.record_finished(req)
            self.obs.events.emit("rejected", req.req_id, reason="deadline",
                                 waited_s=now - req.submit_time, deadline_s=req.deadline_s)
            if self._recorder is not None:
                self._recorder.record_finish(req)
            finished.append(req)

    def _should_evict(self, req: Request) -> bool:
        return self.policies.eviction.should_evict(req)

    def _evict(self, slot: int, finished: list[Request]) -> None:
        req = self.scheduler.release(slot)
        self.store.free(slot)
        if self._drafter is not None:
            with model_parallel(None):
                self._drafter.release(slot)
        self._greedy[slot] = True   # free lanes sample nothing
        reason_of = getattr(self.policies.eviction, "evict_reason", None)
        reason = reason_of(req) if reason_of is not None else req.finish_reason
        if reason == "deadline" and not req.done:
            # DeadlinePreemption took the lane back from a request that
            # already missed its deadline, for queued work that still can
            req.finish_reason_override = "deadline"
            self.metrics.inc("deadline_preempt")
            self.obs.events.emit("evicted", req.req_id, slot=slot, reason="deadline",
                                 n_tokens=len(req.output_tokens),
                                 deadline_s=req.deadline_s)
        self.metrics.record_finished(req)
        extra = {}
        if req.deadline_s is not None:
            extra["deadline_s"] = req.deadline_s
            extra["deadline_hit"] = req.deadline_hit
        self.obs.events.emit("finished", req.req_id, slot=slot,
                             n_tokens=len(req.output_tokens), reason=reason,
                             latency_s=req.latency_s, **extra)
        if self._recorder is not None:
            self._recorder.record_finish(req)
        finished.append(req)

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def run(self, arrivals=None, max_steps: int = 100_000,
            on_token=None) -> EngineMetrics:
        """Drive steps until idle.  ``arrivals``: ``(step_idx, prompt,
        max_new_tokens[, SamplingParams])`` tuples injected when the engine
        reaches that step.  ``on_token(req, tok)``, if given, streams every
        arrival's tokens as they reach the host."""
        pending = sorted(arrivals or [], key=lambda a: a[0])
        i = 0
        steps = 0
        while (i < len(pending) or self.has_work) and steps < max_steps:
            while i < len(pending) and pending[i][0] <= self._step_idx:
                arr = pending[i]
                req = self.add_request(arr[1], arr[2],
                                       sampling=arr[3] if len(arr) > 3 else None)
                if on_token is not None:
                    req.on_token = functools.partial(on_token, req)
                i += 1
            if not self.has_work:
                self._step_idx = pending[i][0]  # idle gap: jump to the arrival
                continue
            self.step()
            steps += 1
        return self.metrics

    def stream(self, prompt: Sequence[int], max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               eos_token: Optional[int] = None) -> Iterator[int]:
        """Submit a request and yield its tokens as the engine produces
        them, driving ``step()`` in between.  Other queued requests advance
        normally -- the single-caller convenience over the ``on_token``
        hook."""
        emitted: list[int] = []
        req = self.add_request(prompt, max_new_tokens, sampling=sampling,
                               eos_token=eos_token, on_token=emitted.append)
        yield from self.follow(req, emitted)

    def follow(self, req: Request, emitted: list) -> Iterator:
        """Yield what a hook of ``req`` appends to ``emitted``, stepping the
        engine until ``req`` finishes (or the engine runs dry)."""
        i = 0
        while True:
            while i < len(emitted):
                yield emitted[i]
                i += 1
            if req.state is RequestState.FINISHED or not self.has_work:
                break
            self.step()
        yield from emitted[i:]
