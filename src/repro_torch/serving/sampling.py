"""Token sampling for the serving engine: greedy only in this slice.

Port of ``repro/serving/sampling.py``.  Stochastic sampling needs the
reference's per-(request, position) keys (``request_key`` is
``jax.random``), which the port has no counterpart for yet; asking for it
raises (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy: deterministic greedy, the only policy
    of this slice."""

    greedy: bool = True

    def __post_init__(self):
        if not self.greedy:
            raise NotImplementedError(
                "stochastic sampling is not ported yet (ROADMAP queue 1, "
                "item 5); use greedy=True")


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax (first maximum on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
