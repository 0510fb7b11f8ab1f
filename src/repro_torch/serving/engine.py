"""Continuous-batching serving engine (port of ``repro/serving/engine.py``).

One ``ServingEngine`` owns ``n_slots`` KV-cache lanes and runs an
iteration-level loop.  The cache is one of two stores:

* ``"slot"`` (the default) -- ``slots.SlotCache``: every lane holds
  ``cache_len`` contiguous rows;
* ``"paged"`` -- ``paging.PagedCache``: KV lives in a global page pool,
  each lane's rows found through its block-table row.

Every ``step()``

1. **admits** the FIFO head (in paged mode only if the pool can reserve
   its worst case): a batch=1 prefill, padded to the smallest prefill
   bucket, whose cache is copied into the lane (slot mode: ``cache_len``
   rows; paged mode: the bucket rounded up to whole pages, into the lane's
   fresh pages) and whose last-position logits give the first token;
2. **decodes** one token for every occupied lane in one ``decode_step``
   over the whole store, with the ``active`` mask pinning idle lanes;
3. **evicts** lanes that reached their budget or EOS, freeing the lane
   (and returning its pages to the pool) the same step.

Tokens reach the host every step (the reference defers the pull while no
scheduling decision needs it; the streams are the same).

Not ported yet, and refused with ``NotImplementedError``: chunked prefill,
prefix caching, speculative decoding, stacked admission, defrag,
observability / flight recorder, device meshes and stochastic sampling
(ROADMAP queue 1, item 5).
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
from repro_torch.paging import PagedCache
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import SamplingParams, greedy_tokens
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.slots import SlotCache

_LATER = "not ported yet (ROADMAP queue 1, item 5)"


def _roundup(n: int, m: int) -> int:
    return pages_for(n, m) * m


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape/policy knobs (model behaviour stays in ``ModelConfig``)."""

    n_slots: int = 4
    cache_len: int = 256
    # prompts pad up to the smallest bucket >= len(prompt); None/() = exact
    prefill_buckets: Optional[tuple[int, ...]] = None
    eos_token: Optional[int] = None
    # "slot" (per-lane cache_len rows) | "paged" (global page pool)
    cache_mode: str = "slot"
    page_size: int = DEFAULT_PAGE_SIZE
    # pool size in pages; None = the slot-equivalent KV budget
    n_pages: Optional[int] = None
    # options of the reference engine that later slices port
    prefill_chunk: Optional[int] = None
    prefix_cache: bool = False
    spec: Optional[object] = None


class EngineMetrics:
    """Counters and timers of an engine run; ``report()`` summarizes them.
    Times are host clocks around work that ends in a device sync (every
    step pulls its tokens to the host)."""

    def __init__(self):
        self.finished: list[Request] = []
        self.steps = 0
        self.prefills = 0
        self.decode_steps = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.peak_running = 0
        self.peak_pages_used = 0
        self.wall_start: Optional[float] = None
        self.wall_end: Optional[float] = None

    def report(self) -> dict:
        gen = sum(len(r.output_tokens) for r in self.finished)
        wall = ((self.wall_end - self.wall_start)
                if self.wall_start is not None and self.wall_end is not None else 0.0)
        ttfts = [r.ttft_s for r in self.finished if r.ttft_s is not None]
        lats = [r.latency_s for r in self.finished if r.latency_s is not None]
        return {
            "finished": len(self.finished),
            "generated_tokens": gen,
            "steps": self.steps,
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "wall_s": wall,
            "tokens_per_s": gen / wall if wall > 0 else 0.0,
            "decode_step_mean_s": (self.decode_s / self.decode_steps
                                   if self.decode_steps else 0.0),
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "latency_mean_s": float(np.mean(lats)) if lats else 0.0,
            "peak_running": self.peak_running,
            "peak_pages_used": self.peak_pages_used,
        }


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 device=None, policies=None, obs=None, mesh=None):
        ecfg = engine_cfg
        if ecfg.cache_mode not in ("slot", "paged"):
            raise ValueError(f"cache_mode must be 'slot' or 'paged', got "
                             f"{ecfg.cache_mode!r}")
        for name, value in (("prefill_chunk", ecfg.prefill_chunk),
                            ("spec", ecfg.spec), ("policies", policies),
                            ("obs", obs), ("mesh", mesh)):
            if value is not None:
                raise NotImplementedError(f"{name} is {_LATER}")
        if ecfg.prefix_cache:
            raise NotImplementedError(f"prefix_cache is {_LATER}")
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
        n = ecfg.n_slots
        self.scheduler = Scheduler(n)
        self.metrics = EngineMetrics()
        if self.paged:
            self.store = PagedCache(cfg, n, ecfg.cache_len, ecfg.page_size,
                                    ecfg.n_pages, device=self.device)
        else:
            self.store = SlotCache(cfg, n, ecfg.cache_len, device=self.device)
        # each lane's next decode input (the token it sampled last)
        self._tokens = torch.zeros((n,), dtype=torch.int32, device=self.device)
        self._next_id = 0
        self._step_idx = 0

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def add_request(self, prompt: Sequence[int], max_new_tokens: int,
                    sampling: Optional[SamplingParams] = None,
                    eos_token: Optional[int] = None, on_token=None, on_text=None,
                    detokenizer=None) -> Request:
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
            pages = pages_for(self._reserve_rows(len(prompt), max_new_tokens),
                              self.engine_cfg.page_size)
            usable = self.store.n_pages - 1  # page 0 is the trash page
            if pages > usable:
                raise ValueError(f"request reserves {pages} pages but the pool only "
                                 f"has {usable} usable pages; raise n_pages")
        req = Request(
            req_id=self._next_id, prompt=prompt, max_new_tokens=max_new_tokens,
            sampling=sampling or SamplingParams(),
            eos_token=self.engine_cfg.eos_token if eos_token is None else eos_token,
            on_token=on_token, on_text=on_text, detokenizer=detokenizer,
            submit_time=time.perf_counter())
        self._next_id += 1
        self.scheduler.submit(req)
        return req

    def _bucket_len(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        return prompt_len

    def _single_len(self, prompt_len: int) -> int:
        """Rows the batch=1 admission prefill allocates: the bucket rounded
        up to whole pages."""
        return _roundup(self._bucket_len(prompt_len), self.engine_cfg.page_size)

    def _reserve_rows(self, prompt_len: int, max_new_tokens: int) -> int:
        """Rows a request reserves: its admission footprint or prompt +
        budget, whichever is larger, capped at the block-table width."""
        worst = max(self._single_len(prompt_len), prompt_len + max_new_tokens)
        return min(worst, self.store.max_pages * self.engine_cfg.page_size)

    def _admit_ok(self, req: Request) -> bool:
        return self.store.manager.can_admit(
            self._reserve_rows(req.prompt_len, req.max_new_tokens))

    def _admit(self, req: Request, slot: int) -> None:
        """Prefill batch=1 and copy its cache into the lane; the logits give
        token 1.  Paged mode first reserves the worst case and takes the
        prefill's pages."""
        padded = self._bucket_len(req.prompt_len)
        if self.paged:
            mgr = self.store.manager
            single_len = self._single_len(req.prompt_len)
            mgr.admit(slot, self._reserve_rows(req.prompt_len, req.max_new_tokens))
            page_ids = mgr.alloc(slot, single_len // self.engine_cfg.page_size)
            mgr.set_length(slot, req.prompt_len)
        else:
            single_len = self.engine_cfg.cache_len
        tokens = torch.zeros((1, padded), dtype=torch.int32)
        tokens[0, :req.prompt_len] = torch.tensor(req.prompt, dtype=torch.int32)
        tokens = tokens.to(self.device)
        lengths = torch.tensor([req.prompt_len], dtype=torch.int32, device=self.device)
        logits, single = model_lib.prefill(self.params, self.cfg, tokens, single_len,
                                           lengths=lengths)
        tok = greedy_tokens(logits)
        if self.paged:
            self.store.insert(single, slot, page_ids, req.prompt_len)
        else:
            self.store.insert(single, slot)
        self._tokens[slot] = tok[0]
        req.append_token(int(tok[0]))   # host pull: stamps TTFT
        self.metrics.prefills += 1

    # ------------------------------------------------------------------
    # The engine loop
    # ------------------------------------------------------------------
    def step(self) -> list[Request]:
        """One scheduler iteration: admissions, then one batched decode over
        all occupied lanes. Returns requests finished this step."""
        m = self.metrics
        if m.wall_start is None:
            m.wall_start = time.perf_counter()
        self._step_idx += 1
        m.steps += 1
        finished: list[Request] = []

        t0 = time.perf_counter()
        got = self.scheduler.schedule_one(self._admit_ok if self.paged else None)
        if got is not None:
            req, slot = got
            self._admit(req, slot)
            if req.done:  # max_new_tokens == 1 (or instant EOS)
                self._evict(slot, finished)
            m.prefill_s += time.perf_counter() - t0

        running = self.scheduler.running
        m.peak_running = max(m.peak_running, len(running))
        if running:
            t0 = time.perf_counter()
            if self.paged:
                mgr = self.store.manager
                for slot in running:
                    mgr.ensure(slot, int(mgr.lengths[slot]) + 1)
                self.store.sync_tables()
                m.peak_pages_used = max(m.peak_pages_used, mgr.pages_in_use)
            active = np.zeros((self.engine_cfg.n_slots,), bool)
            active[list(running)] = True
            logits, _ = model_lib.decode_step(
                self.params, self.cfg, self._tokens, self.store.cache,
                active=torch.from_numpy(active).to(self.device))
            self._tokens = greedy_tokens(logits)
            if self.paged:
                mgr.advance(running)
            toks = self._tokens.cpu().numpy()
            for slot, req in list(running.items()):
                req.append_token(int(toks[slot]))
                if req.done:
                    self._evict(slot, finished)
            m.decode_steps += 1
            m.decode_s += time.perf_counter() - t0
        m.wall_end = time.perf_counter()
        return finished

    def _evict(self, slot: int, finished: list[Request]) -> None:
        req = self.scheduler.release(slot)
        self.store.free(slot)
        req.finish_time = time.perf_counter()
        self.metrics.finished.append(req)
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
