"""Request lifecycle for the continuous-batching engine.

Port of ``repro/serving/request.py``: a request moves WAITING -> RUNNING
-> FINISHED; a single-shot admission (prefill + first token) happens
inside one engine step.  Only the paged engine's chunked admissions pass
through PREFILLING, holding their lane across the steps that feed the
prompt in page-aligned chunks.  All bookkeeping is host-side Python.
Token and text streaming ride the ``on_token`` / ``on_text`` hooks.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Optional, Sequence

from repro_torch.serving.sampling import SamplingParams


def default_detokenizer(token_ids: Sequence[int]) -> str:
    """Fallback detokenizer: renders each token id as ``<id>`` (the repo
    carries no vocabulary; real deployments pass their tokenizer's
    ``decode``)."""
    return "".join(f"<{int(t)}>" for t in token_ids)


class RequestState(enum.Enum):
    WAITING = "waiting"        # queued, no lane yet
    PREFILLING = "prefilling"  # lane held, prompt chunks still streaming in
    RUNNING = "running"        # occupies a lane, decoding
    FINISHED = "finished"      # evicted (or shed); outputs final


@dataclasses.dataclass
class RequestCost:
    """Per-request resource attribution, accumulated by the engine.

    Times are host clocks around each dispatch, split evenly across the
    requests riding a batched decode, so the per-phase totals sum to the
    engine's dispatch time.  ``page_steps`` integrates pages held per
    decode step (paged engines): the request's KV memory x time;
    ``verify_s`` is its share of speculative draft + verify rounds."""

    prefill_s: float = 0.0
    decode_s: float = 0.0
    verify_s: float = 0.0
    dispatches: int = 0
    page_steps: int = 0

    def as_dict(self) -> dict:
        return {"prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "verify_s": self.verify_s, "dispatches": self.dispatches,
                "page_steps": self.page_steps}


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens in, sampled tokens out."""

    req_id: int
    prompt: list[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_token: Optional[int] = None
    # admission rank for priority admission (higher = sooner); FIFO
    # admission ignores it (policies.PriorityAdmission)
    priority: int = 0

    # streaming hooks, called as each token reaches the host: the token id,
    # and the new text fragment (the whole output re-decoded through
    # ``detokenizer``, so a multi-token character surfaces once complete)
    on_token: Optional[Callable[[int], None]] = dataclasses.field(default=None, repr=False)
    on_text: Optional[Callable[[str], None]] = dataclasses.field(default=None, repr=False)
    detokenizer: Optional[Callable[[Sequence[int]], str]] = dataclasses.field(
        default=None, repr=False)

    # SLO deadline (seconds from submit); taken from ``sampling.deadline_s``
    # at ``add_request`` unless passed explicitly
    deadline_s: Optional[float] = None
    # stamped by the scheduler when the deadline already expired in queue
    late_at_admission: bool = False
    # engine-stamped terminal reason that overrides the eos/length
    # inference ("deadline" for shed or preempted requests)
    finish_reason_override: Optional[str] = None

    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    cost: RequestCost = dataclasses.field(default_factory=RequestCost, repr=False)
    output_tokens: list[int] = dataclasses.field(default_factory=list)
    # text already emitted through ``on_text``
    emitted_text: str = dataclasses.field(default="", repr=False)
    # chunked admission progress: prompt tokens already prefilled
    prefill_done: int = 0

    # timeline (engine-stamped): ``submit_time`` and ``admit_time`` on the
    # engine's decision clock, the rest on ``time.perf_counter``
    submit_time: float = 0.0
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        if len(self.output_tokens) >= self.max_new_tokens:
            return True
        return (self.eos_token is not None and bool(self.output_tokens)
                and self.output_tokens[-1] == self.eos_token)

    def append_token(self, tok: int) -> None:
        if self.first_token_time is None:
            self.first_token_time = time.perf_counter()
        self.output_tokens.append(tok)
        if self.on_token is not None:
            self.on_token(tok)
        if self.on_text is not None:
            full = self.decode_text()
            delta = full[len(self.emitted_text):]
            if delta:
                self.on_text(delta)
            self.emitted_text = full

    def decode_text(self) -> str:
        """The output so far through the request's detokenizer."""
        return (self.detokenizer or default_detokenizer)(self.output_tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (submit -> first sampled token)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.submit_time

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Time spent WAITING (submit -> admitted into a lane)."""
        if self.admit_time is None:
            return None
        return self.admit_time - self.submit_time

    @property
    def deadline_hit(self) -> Optional[bool]:
        """Finished inside the deadline?  None while in flight or without a
        deadline (no-deadline requests always count toward goodput)."""
        if self.deadline_s is None or self.latency_s is None:
            return None
        return self.latency_s <= self.deadline_s

    @property
    def finish_reason(self) -> Optional[str]:
        """``"eos"``, ``"length"`` or an engine override like
        ``"deadline"`` (None while in flight)."""
        if self.state is not RequestState.FINISHED:
            return None
        if self.finish_reason_override is not None:
            return self.finish_reason_override
        if (self.eos_token is not None and self.output_tokens
                and self.output_tokens[-1] == self.eos_token):
            return "eos"
        return "length"
