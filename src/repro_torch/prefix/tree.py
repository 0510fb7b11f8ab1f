"""Token-ID radix tree over page-aligned prompt prefixes.

Port of ``repro/prefix/tree.py`` (stdlib only, copied so that the port imports
nothing of the JAX package).

The tree maps token sequences to chains of *physical* KV pages: a node's
``key`` is a run of token ids whose length is a whole number of pages and
``pages`` holds the physical page ids storing those rows.  Edges are
path-compressed (one node can span many pages) but every structural
boundary — node splits, matches, inserts — happens on a page boundary,
because pages are the unit of sharing: a partially-filled page mixes one
request's rows with another's future rows, so it can never be aliased.

The tree itself is pure host-side bookkeeping; it never touches device
memory.  Page *ownership* (refcounts, free lists) lives in
``paging.PageManager`` — callers pair every structural change here with
the matching ``tree_ref``/``tree_unref`` there.

Siblings always differ within their first page (splits guarantee it), so
children are keyed by the first ``page_size`` tokens of their key.
Matching walks whole nodes and splits on a partial hit, which keeps the
"adopted pages form complete nodes" invariant the LRU eviction relies on:
a node's pages are either all shared with some lane or none are.

Recency is a deterministic logical clock (no wall time): ``match`` and
``insert`` touch the path they walk, and ``evict`` removes least-recently
used *leaves* first (children before parents), so a hot system prompt's
trunk survives while one-off tails age out.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence


class PrefixNode:
    __slots__ = ("key", "pages", "children", "parent", "last_used")

    def __init__(self, key: tuple[int, ...], pages: list[int],
                 parent: Optional["PrefixNode"]):
        self.key = key
        self.pages = pages
        self.children: dict[tuple[int, ...], PrefixNode] = {}
        self.parent = parent
        self.last_used = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children


class PrefixTree:
    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self.root = PrefixNode((), [], None)
        self._clock = 0

    # -- internals ---------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _edge(self, tokens: tuple[int, ...]) -> tuple[int, ...]:
        return tokens[: self.page_size]

    def _match_pages(self, key: tuple[int, ...], tokens: Sequence[int],
                     start: int) -> int:
        """Whole pages of ``key`` matched by ``tokens[start:]``."""
        ps = self.page_size
        full = 0
        for i in range(0, len(key), ps):
            seg = tuple(tokens[start + i: start + i + ps])
            if seg != key[i: i + ps]:
                break
            full += 1
        return full

    def _split(self, node: PrefixNode, n_pages: int) -> PrefixNode:
        """Split ``node`` after its first ``n_pages`` pages; returns the new
        upper node (which keeps ``node``'s place in the tree)."""
        ps = self.page_size
        assert 0 < n_pages < len(node.pages)
        upper = PrefixNode(node.key[: n_pages * ps], node.pages[:n_pages],
                           node.parent)
        upper.last_used = node.last_used
        node.key = node.key[n_pages * ps:]
        node.pages = node.pages[n_pages:]
        node.parent.children[self._edge(upper.key)] = upper
        upper.children[self._edge(node.key)] = node
        node.parent = upper
        return upper

    # -- the public surface ------------------------------------------------
    def match(self, tokens: Sequence[int]
              ) -> tuple[list[int], tuple[PrefixNode, ...]]:
        """Longest page-aligned cached prefix of ``tokens``.

        Returns (physical pages covering the match, the matched node path).
        Only whole pages match — there is no sharing below page granularity.
        Splits a partially-matched node so the returned path's nodes are
        covered end to end (the all-or-none adoption invariant).
        """
        ps = self.page_size
        node, at = self.root, 0
        pages: list[int] = []
        path: list[PrefixNode] = []
        stamp = self._tick()
        while len(tokens) - at >= ps:
            child = node.children.get(tuple(tokens[at: at + ps]))
            if child is None:
                break
            n = self._match_pages(child.key, tokens, at)
            if n == 0:
                break
            if n < len(child.pages):
                child = self._split(child, n)
            child.last_used = stamp
            pages.extend(child.pages)
            path.append(child)
            at += len(child.key)
            node = child
        return pages, tuple(path)

    def insert(self, tokens: Sequence[int], pages: Sequence[int]
               ) -> list[int]:
        """Publish ``tokens`` (a whole number of pages) backed by ``pages``.

        Walks the existing structure; where the tree already covers a region
        the tree's pages win (the caller's duplicates stay lane-owned and
        die with the lane).  Returns the page ids NEWLY referenced by the
        tree — the caller increfs exactly those.
        """
        ps = self.page_size
        if len(tokens) % ps:
            raise ValueError("insert length must be a whole number of pages")
        if len(tokens) // ps != len(pages):
            raise ValueError("token/page length mismatch")
        tokens = tuple(int(t) for t in tokens)
        node, at = self.root, 0
        stamp = self._tick()
        while at < len(tokens):
            child = node.children.get(tokens[at: at + ps])
            if child is None:
                fresh = PrefixNode(tokens[at:], list(pages[at // ps:]), node)
                fresh.last_used = stamp
                node.children[self._edge(fresh.key)] = fresh
                return fresh.pages[:]
            n = self._match_pages(child.key, tokens, at)
            if n < len(child.pages):
                child = self._split(child, n)
            child.last_used = stamp
            at += len(child.key)
            node = child
        return []

    def touch(self, path: Sequence[PrefixNode]) -> None:
        stamp = self._tick()
        for node in path:
            node.last_used = stamp

    def evict(self, n_pages: int,
              evictable: Callable[[PrefixNode], bool],
              protect: Sequence[PrefixNode] = ()) -> list[int]:
        """Drop least-recently-used leaves until ``n_pages`` page ids have
        been released (or nothing evictable remains).  ``evictable`` vetoes
        nodes whose pages are still shared with running lanes; ``protect``
        pins a path (e.g. the match an in-flight admission is about to
        adopt).  Evicting a leaf may expose its parent as the next LRU leaf.
        """
        pinned = set(id(n) for n in protect)
        released: list[int] = []
        while len(released) < n_pages:
            victim = None
            for node in self.nodes():
                if not node.is_leaf or id(node) in pinned:
                    continue
                if not evictable(node):
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            del victim.parent.children[self._edge(victim.key)]
            released.extend(victim.pages)
        return released

    def remap(self, mapping: dict[int, int]) -> None:
        """Rewrite physical page ids after a pool defrag."""
        for node in self.nodes():
            node.pages = [mapping.get(p, p) for p in node.pages]

    # -- introspection -----------------------------------------------------
    def nodes(self) -> Iterator[PrefixNode]:
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    @property
    def total_pages(self) -> int:
        return sum(len(n.pages) for n in self.nodes())

    @property
    def n_nodes(self) -> int:
        return sum(1 for _ in self.nodes())
