"""Request lifecycle for the continuous-batching engine.

Port of ``repro/serving/request.py``: a request moves WAITING -> RUNNING
-> FINISHED; admission (prefill + first token) happens inside one engine
step.  All bookkeeping is host-side Python.  Token and text streaming
ride the ``on_token`` / ``on_text`` hooks.  Cost attribution, deadlines
and priorities are later slices (ROADMAP queue 1).
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
    WAITING = "waiting"      # queued, no lane yet
    RUNNING = "running"      # occupies a lane, decoding
    FINISHED = "finished"    # evicted; outputs final


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens in, sampled tokens out."""

    req_id: int
    prompt: list[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_token: Optional[int] = None

    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    output_tokens: list[int] = dataclasses.field(default_factory=list)

    # streaming hooks, called as each token reaches the host: the token id,
    # and the new text fragment (the whole output re-decoded through
    # ``detokenizer``, so a multi-token character surfaces once complete)
    on_token: Optional[Callable[[int], None]] = dataclasses.field(default=None, repr=False)
    on_text: Optional[Callable[[str], None]] = dataclasses.field(default=None, repr=False)
    detokenizer: Optional[Callable[[Sequence[int]], str]] = dataclasses.field(
        default=None, repr=False)
    # text already emitted through ``on_text``
    emitted_text: str = dataclasses.field(default="", repr=False)

    # wall-clock timeline (engine-stamped)
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
