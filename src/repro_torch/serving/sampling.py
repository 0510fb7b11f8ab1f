"""Token sampling for the serving engine: greedy only in this slice.

Port of ``repro/serving/sampling.py``.  Stochastic sampling needs the
reference's per-(request, position) keys (``request_key`` is
``jax.random``), which the port has no counterpart for yet; asking for it
raises (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy: deterministic greedy, the only policy
    of this slice."""

    greedy: bool = True
    # SLO deadline: seconds from submit to finish.  An accounting
    # annotation (the engine stamps hit/miss at finish and only
    # deadline-respecting requests count toward goodput) that deadline
    # admission and eviction policies also read.  None = no deadline.
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if not self.greedy:
            raise NotImplementedError(
                "stochastic sampling is not ported yet (ROADMAP queue 1, "
                "item 5); use greedy=True")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (None = no SLO)")


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax (first maximum on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
