"""Model-free prompt-lookup drafter (PLD-style n-gram matching).

Port of ``repro/spec/ngram.py`` (plain Python).

Proposals are free: match the lane's trailing n-gram against its own
prompt + generated suffix (most recent earlier occurrence wins) and, on a
miss, against the token paths of the prefix cache's radix tree
(``repro_torch/prefix/``) — shared prefixes across requests are exactly
where repeated continuations live.  Wins on repetitive / agentic workloads (tool-call
loops, code edits, extraction over a quoted document) where the next few
tokens usually already appear verbatim upstream; on free-form text the
acceptance rate decays toward zero and the draft-model drafter takes
over.  Entirely deterministic: ties break toward the longest n-gram,
then the most recent occurrence, then lexicographically smallest tree
path — re-running a workload reproposes identical drafts.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.spec.config import SpecConfig


def _lookup(hist: Sequence[int], pattern: Sequence[int], k: int) -> Optional[list[int]]:
    """Continuation after the most recent earlier occurrence of ``pattern``
    in ``hist`` (the occurrence ending before the final token), or None."""
    n = len(pattern)
    pattern = list(pattern)
    for start in range(len(hist) - n - 1, -1, -1):
        if list(hist[start:start + n]) == pattern:
            return [int(t) for t in hist[start + n:start + n + k]]
    return None


class NgramDrafter:
    """Stateless per-lane; ``tree`` (a ``PrefixTree`` or None) is only read."""

    name = "ngram"

    def __init__(self, spec: SpecConfig, tree=None):
        self.spec = spec
        self.tree = tree

    # -- lane lifecycle (no per-lane state to keep) -------------------------
    def admit(self, slot: int, history: Sequence[int]) -> None:
        pass

    def release(self, slot: int) -> None:
        pass

    def propose(self, slots: Sequence[int],
                histories: Sequence[Sequence[int]]) -> list[list[int]]:
        """Up to ``spec.k`` drafted tokens per lane (may be shorter/empty).

        ``histories[i]`` is lane ``slots[i]``'s prompt + generated tokens,
        the final element being the next decode input t0.
        """
        return [self._propose_one(h) for h in histories]

    def _propose_one(self, hist: Sequence[int]) -> list[int]:
        k = self.spec.k
        n_max = min(self.spec.ngram_max, len(hist) - 1)
        for n in range(n_max, self.spec.ngram_min - 1, -1):
            pattern = [int(t) for t in hist[-n:]]
            cont = _lookup(hist, pattern, k)
            if cont:
                return cont
            cont = self._tree_lookup(pattern, k)
            if cont:
                return cont
        return []

    def _tree_lookup(self, pattern: list[int], k: int) -> Optional[list[int]]:
        """Scan radix-tree token paths for ``pattern``'s continuation.

        Paths are visited in sorted order and the *rightmost* occurrence
        within a path wins, mirroring ``_lookup``'s recency preference —
        deterministic regardless of dict/insertion order.
        """
        if self.tree is None:
            return None
        n = len(pattern)
        paths = []
        for node in self.tree.nodes():
            toks, cur = [], node
            while cur is not None and cur.key:
                toks = list(cur.key) + toks
                cur = cur.parent
            if len(toks) > n:
                paths.append(tuple(toks))
        for path in sorted(paths):
            for start in range(len(path) - n - 1, -1, -1):
                if list(path[start:start + n]) == pattern:
                    return [int(t) for t in path[start + n:start + n + k]]
        return None
