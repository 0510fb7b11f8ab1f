"""Token sampling for the serving engine: greedy, temperature, top-k.

Port of ``repro/serving/sampling.py``.  Each lane may carry its own policy,
so sampling takes per-lane arrays (temperature / top_k / greedy mask / key)
rather than one policy for the batch.  ``top_k <= 0`` disables the top-k
filter for that lane; greedy lanes ignore the randomness entirely, so a
greedy request's tokens are bitwise the argmax whatever shares the batch.

The reference draws from ``jax.random`` streams, which a PyTorch program
cannot reproduce.  The port's stream is its own: :func:`request_key` mixes
(seed, request id, token index) with splitmix64 on the host, and
:func:`sample_tokens` seeds one ``torch.Generator`` per lane and step from
that key alone, on the logits' device.  So a lane's token depends only on
its key and its own logits row, never on its neighbours; the same seed
gives the same stream; ``top_k=1`` gives the greedy token; and the draws
follow the (temperature-scaled, top-k-truncated) softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

_TEMP_EPS = 1e-4
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy. Defaults to deterministic greedy."""

    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0          # <= 0: no top-k truncation
    seed: int = 0           # folded into the per-token key with the request id
    # SLO deadline: seconds from submit to finish.  An accounting
    # annotation (the engine stamps hit/miss at finish and only
    # deadline-respecting requests count toward goodput) that deadline
    # admission and eviction policies also read.  None = no deadline.
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if not self.greedy and self.temperature <= 0:
            raise ValueError("temperature must be > 0 for stochastic sampling "
                             "(use greedy=True for argmax decoding)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (None = no SLO)")


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_key(seed: int, req_id: int, token_index: int) -> int:
    """Per-(request, position) key: a counter-based splitmix64 mix of the
    three integers.  It depends only on the request's own seed, id and how
    many tokens it has produced -- never on which other requests share the
    batch -- so stochastic outputs are reproducible under any
    continuous-batching interleaving.  Returns a non-negative int below
    2**63 (a ``torch.Generator`` seed)."""
    k = _splitmix64(int(seed) & _MASK64)
    k = _splitmix64(k ^ (int(req_id) & _MASK64))
    k = _splitmix64(k ^ (int(token_index) & _MASK64))
    return k >> 1


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax (first maximum on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, temperature: Sequence[float],
                  top_k: Sequence[int], greedy: Sequence[bool],
                  keys: Sequence[int]) -> torch.Tensor:
    """Sample one token per lane (``repro/serving/sampling.py:55-76``).

    logits: (B, V); temperature (B,) floats, top_k (B,) ints (<= 0
    disables), greedy (B,) bools, keys (B,) ints from :func:`request_key`
    (ignored for greedy lanes) -- host sequences.  A stochastic lane scales
    its row by ``max(temperature, 1e-4)``, keeps the values at or above its
    k-th largest, and draws by Gumbel-max with noise from a generator
    seeded by its key on the logits' device.  Returns (B,) int32."""
    logits = logits.float()
    out = greedy_tokens(logits)
    for b in range(logits.shape[0]):
        if greedy[b]:
            continue
        row = logits[b] / max(float(temperature[b]), _TEMP_EPS)
        k = int(top_k[b])
        if 0 < k < row.shape[0]:
            kth = torch.topk(row, k).values[-1]
            row = torch.where(row >= kth, row, torch.full_like(row, -torch.inf))
        gen = torch.Generator(device=row.device).manual_seed(int(keys[b]))
        u = torch.rand(row.shape, generator=gen, device=row.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[b] = torch.argmax(row + gumbel).to(torch.int32)
    return out
