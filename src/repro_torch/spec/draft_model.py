"""Draft-model drafter: a small transformer proposes, the target verifies.

Port of ``repro/spec/draft_model.py`` on the port's ``SlotCache``,
``prefill`` and ``decode_step``.  The draft model runs its own slot cache,
aligned lane-for-lane with the engine's: row ``i`` of a lane's draft cache
was written by feeding token ``i`` of that lane's sequence.  Rather than
being told accept/reject results, the drafter re-derives validity at
propose time by comparing the tokens it actually fed (``_fed``) against
the lane's true history -- the longest common prefix is the count of
valid draft-cache rows, and the lane's position is rolled back to it.
After a verify with ``a`` accepted drafts the catch-up (history beyond
the common prefix) is always 1 token (partial accept / rejection) or 2
(full accept: the bonus token plus the next input), so a spec step costs
at most one catch-up dispatch + ``k`` draft dispatches, each batched
across all proposing lanes.

Weights come from ``init_params(draft_cfg, seed=spec.draft_seed)`` on the
engine's device (``params`` may be replaced, for example by
``params_from_jax`` of the reference drafter's weights).
"""

from __future__ import annotations

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.serving.sampling import greedy_tokens
from repro_torch.serving.slots import SlotCache, scatter_lane
from repro_torch.spec.config import SpecConfig


def draft_config(target: ModelConfig, spec: SpecConfig) -> ModelConfig:
    """Derive the draft architecture: ``spec.draft_arch`` names a registry
    config (reduced to smoke size, vocab forced to the target's so
    proposals index the same token space); otherwise the target truncated
    to ``spec.draft_layers`` layers: its lead dense layers plus whole
    periods of its pattern."""
    if spec.draft_arch is not None:
        cfg = reduced(get_config(spec.draft_arch)).with_(vocab_size=target.vocab_size)
    else:
        lead = target.moe.first_k_dense if target.moe is not None else 0
        period = target.pattern_period
        cfg = target.with_(n_layers=lead + period * max(
            1, (spec.draft_layers - lead) // period))
    return cfg


class DraftModelDrafter:
    name = "model"

    def __init__(self, spec: SpecConfig, target_cfg: ModelConfig, n_slots: int,
                 cache_len: int, device=None):
        self.spec = spec
        self.cfg = draft_config(target_cfg, spec)
        if self.cfg.is_encoder_decoder or self.cfg.frontend is not None:
            # the reference fails later, at the first admission's prefill
            raise ValueError(f"a draft model of {self.cfg.name} takes no token "
                             "prompts: encoder-decoder and frontend archs cannot draft")
        self.cache_len = cache_len
        self.store = SlotCache(self.cfg, n_slots, cache_len, device=device)
        self.device = self.store.device
        self.params = model_lib.init_params(self.cfg, seed=spec.draft_seed,
                                            device=self.device)
        # tokens fed to the draft cache per lane: row i <- _fed[slot][i]
        self._fed: dict[int, list[int]] = {}
        self.dispatches = 0   # draft-model forward passes (admissions + steps)

    # -- lane lifecycle -----------------------------------------------------
    def admit(self, slot: int, history) -> None:
        """Prefill the lane's prompt into its draft-cache lane (no sampling:
        the target supplies t0; the draft only needs the rows)."""
        prompt = [int(t) for t in history]
        tokens = torch.tensor([prompt], dtype=torch.int32, device=self.device)
        lengths = torch.tensor([len(prompt)], dtype=torch.int32, device=self.device)
        _, single = model_lib.prefill(self.params, self.cfg, {"tokens": tokens},
                                      self.cache_len, lengths=lengths)
        scatter_lane(self.store.cache, single, slot, self.store._axes)
        self.dispatches += 1
        self._fed[slot] = prompt

    def release(self, slot: int) -> None:
        self._fed.pop(slot, None)
        self.store.free(slot)

    # -- proposal -----------------------------------------------------------
    def _step(self, toks, active, slots) -> torch.Tensor:
        """One greedy draft decode over the whole slot batch.  Positions are
        re-anchored from the fed-token ledger first: ``decode_step`` zeroes
        inactive lanes' pos, so no dispatch trusts the previous one's."""
        cache = self.store.cache
        pos = [0] * self.store.n_slots
        for s in slots:
            pos[s] = len(self._fed[s])
        cache["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
        logits, _ = model_lib.decode_step(
            self.params, self.cfg, torch.tensor(toks, dtype=torch.int32, device=self.device),
            cache, active=torch.tensor(active, device=self.device))
        self.dispatches += 1
        return greedy_tokens(logits)

    def propose(self, slots, histories) -> list[list[int]]:
        """Batched: catch-up dispatches (usually <= 1) + k draft dispatches."""
        n = self.store.n_slots
        pending = {}
        for slot, hist in zip(slots, histories):
            hist = [int(t) for t in hist]
            fed = self._fed.get(slot, [])
            common = 0
            for a, b in zip(fed, hist):
                if a != b:
                    break
                common += 1
            # rows beyond the common prefix were written from rejected
            # drafts: roll the lane back and feed what is missing
            self._fed[slot] = hist[:common]
            pending[slot] = hist[common:]

        # phase 1: lanes more than one token behind (full accept) feed their
        # extra token in one active-masked dispatch
        while any(len(c) > 1 for c in pending.values()):
            toks, active = [0] * n, [False] * n
            feeds = []
            for s, c in list(pending.items()):
                if len(c) > 1:
                    toks[s], active[s] = c[0], True
                    feeds.append((s, c[0]))
                    pending[s] = c[1:]
            self._step(toks, active, slots)
            for s, t in feeds:
                self._fed[s].append(t)

        # phase 2: k greedy draft steps, all proposing lanes at once (feed
        # t0 -> d1, then d_{j-1} -> d_j; the final draft d_k is returned
        # but never fed, so the ledger stays row-aligned)
        toks, active = [0] * n, [False] * n
        for s, c in pending.items():
            toks[s], active[s] = c[0], True
        drafts = {s: [] for s in slots}
        for _ in range(self.spec.k):
            d = self._step(toks, active, slots).cpu().tolist()
            for s in slots:
                self._fed[s].append(int(toks[s]))
                drafts[s].append(int(d[s]))
                toks[s] = d[s]
        return [drafts[s] for s in slots]
