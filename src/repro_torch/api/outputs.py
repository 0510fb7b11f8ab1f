"""Result objects returned by the ``repro_torch.api`` facade (port of
``repro/api/outputs.py``).  With observability on, each output carries
its request's scheduler timeline from the event log, and the queue wait
is read off it (``None`` without one), as in the reference."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.serving.request import Request


@dataclasses.dataclass
class RequestOutput:
    """One finished generation: ids in, ids (and optionally text) out."""

    request_id: int
    prompt_token_ids: list[int]
    token_ids: list[int]
    # decoded text (None unless a detokenizer was supplied or requested)
    text: Optional[str]
    finish_reason: str          # "stop" (EOS) | "length" (budget)
    ttft_s: Optional[float]     # submit -> first token
    latency_s: Optional[float]  # submit -> finished
    # the request's scheduler event timeline (queued -> admitted -> chunks
    # -> first_token -> finished dicts from ``obs.EventLog``); None when
    # observability is disabled
    timeline: Optional[list[dict]] = None
    # SLO outcome: finished within the deadline?  None = no deadline
    deadline_hit: Optional[bool] = None
    # per-request resource attribution (``RequestCost.as_dict()``); None
    # when the engine recorded no dispatch for the request
    cost: Optional[dict] = None

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Submit -> admitted, read off the timeline (None without one)."""
        for ev in self.timeline or ():
            if ev["kind"] == "admitted":
                return ev.get("queue_wait_s")
        return None

    @classmethod
    def from_request(cls, req: Request,
                     detokenizer: Optional[Callable[[Sequence[int]], str]] = None,
                     timeline: Optional[list[dict]] = None) -> "RequestOutput":
        stopped = (req.eos_token is not None and req.output_tokens
                   and req.output_tokens[-1] == req.eos_token)
        return cls(
            request_id=req.req_id,
            prompt_token_ids=list(req.prompt),
            token_ids=list(req.output_tokens),
            text=detokenizer(req.output_tokens) if detokenizer else None,
            finish_reason="stop" if stopped else "length",
            ttft_s=req.ttft_s,
            latency_s=req.latency_s,
            timeline=timeline,
            deadline_hit=req.deadline_hit,
            cost=req.cost.as_dict() if req.cost.dispatches else None,
        )
