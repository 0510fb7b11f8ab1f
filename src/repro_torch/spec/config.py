"""Speculative-decoding configuration.

Port of ``repro/spec/config.py`` (stdlib only, copied so that the port imports
nothing of the JAX package).

Kept dependency-free so it can sit on ``RuntimeConfig`` (``api/``) and
on ``EngineConfig`` (``serving/``) without import cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

DRAFTERS = ("ngram", "model")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Draft-verify loop settings (see ``repro_torch/spec/``).

    ``k`` drafted tokens are verified per dispatch; the verify window is
    ``k + 1`` wide (last accepted token + drafts).  ``ngram`` is the
    model-free prompt-lookup drafter (free proposals; wins on repetitive
    / agentic workloads); ``model`` runs a small draft transformer with
    its own slot cache (costs k small dispatches per step; wins on
    free-form text).
    """

    enabled: bool = False
    k: int = 4
    drafter: str = "ngram"
    # prompt-lookup drafter: longest/shortest trailing n-gram to match
    ngram_max: int = 3
    ngram_min: int = 1
    # draft-model drafter: truncate the target architecture to this many
    # layers (ignored when draft_arch names a config outright)
    draft_layers: int = 2
    draft_arch: Optional[str] = None
    # PRNG seed for the draft model's (dryrun) parameters
    draft_seed: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("spec.k must be >= 1")
        if self.drafter not in DRAFTERS:
            raise ValueError(f"spec.drafter must be one of {DRAFTERS}")
        if self.ngram_min < 1 or self.ngram_max < self.ngram_min:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        if self.draft_layers < 1:
            raise ValueError("spec.draft_layers must be >= 1")

    @property
    def width(self) -> int:
        """Verify-window width: last accepted token + k drafts."""
        return self.k + 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SpecConfig":
        return cls(**d)
