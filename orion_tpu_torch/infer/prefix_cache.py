"""Automatic prefix caching: a radix tree over token-ID sequences whose
nodes own immutable, refcounted KV-cache pages.

Counterpart of ``orion_tpu/infer/prefix_cache.py`` without the host tier
(``HostPage``, ``peek_tiered``, ``demote``, ``evict_host``,
``promote_path``). ``token_paths`` feeds the speculative drafter.
When a request finishes or is preempted, the FULL pages of its context are
inserted into the tree keyed by token ids; a new request matches the
longest cached prefix at page granularity, maps those pages into its page
table (refcount + 1: shared, never written) and prefills only the
uncached tail.

- Page granularity everywhere: edges hold page-multiple token runs, so
  splits land on page boundaries and a matched node maps 1:1 onto pool
  pages. Partial tail pages are never cached, which keeps shared pages
  immutable; the one exception, a fully cached context whose final token's
  KV slot the first decode step rewrites, is handled by the engine with a
  copy-on-write (``kv_cache.copy_page``) into a private page.
- ``node.lock`` counts live requests mapping the node's pages and
  propagates to the root, so ``lock == 0`` means no locker at or below and
  the node is evictable. Page refcounts (``PageAllocator``) are the
  ownership ground truth: the tree holds one ref per cached page, each
  mapping request one more.
- Eviction is LRU at page granularity: the trailing pages of the least
  recently used unlocked leaf go first.
"""

from __future__ import annotations

import itertools
from typing import Optional

from orion_tpu_torch.infer.kv_cache import PageAllocator


class _Node:
    """One radix-tree edge + node: ``key`` is the page-multiple token run on
    the edge INTO this node, ``pages`` the pool pages holding its KV."""

    __slots__ = ("key", "pages", "children", "parent", "lock", "stamp")

    def __init__(self, key: tuple, pages: list, parent: Optional["_Node"]):
        self.key = key                  # len == len(pages) * psz
        self.pages = pages
        # Children keyed by their edge's FIRST PAGE of tokens (siblings may
        # share a first token yet diverge inside the page).
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.lock = 0                   # live requests at/below this node
        self.stamp = 0                  # LRU clock


class PrefixCache:
    """Host-side radix tree of cached KV pages (see module docstring)."""

    def __init__(self, page_size: int, alloc: PageAllocator):
        self.psz = page_size
        self.alloc = alloc
        self.root = _Node((), [], None)
        self._clock = itertools.count(1)
        self.total_pages = 0     # pages owned by the tree
        # Pages in nodes with lock > 0, kept in step by lock/unlock/insert/
        # evict/clear (splits move pages between equal-lock nodes), so
        # evictable_pages() is O(1) on the scheduler's hot path.
        self.locked_pages = 0
        # ``token_paths`` memo: rebuilt only after a structural change
        # (insert of new pages, eviction, clear) bumps the version.
        self._paths_version = 0
        self._paths_cache: Optional[tuple[int, list]] = None

    # -- internals ---------------------------------------------------------

    def _match_edge(self, node: _Node, tokens, i: int, max_pages: int) -> int:
        """Whole pages of ``node.key`` matching ``tokens[i:]`` (<= max_pages)."""
        psz = self.psz
        m = 0
        while (
            m < len(node.pages)
            and m < max_pages
            and i + (m + 1) * psz <= len(tokens)
            and node.key[m * psz:(m + 1) * psz]
            == tuple(tokens[i + m * psz:i + (m + 1) * psz])
        ):
            m += 1
        return m

    def _split(self, node: _Node, m: int) -> _Node:
        """Split ``node``'s edge after ``m`` pages; returns the new UPPER
        node. ``node`` keeps the lower part (so handles held by lockers
        stay valid) and the upper inherits its lock count."""
        psz = self.psz
        assert 0 < m < len(node.pages), (m, len(node.pages))
        upper = _Node(node.key[: m * psz], node.pages[:m], node.parent)
        upper.lock = node.lock
        upper.stamp = node.stamp
        node.parent.children[upper.key[:psz]] = upper
        node.key = node.key[m * psz:]
        node.pages = node.pages[m:]
        node.parent = upper
        upper.children[node.key[:psz]] = node
        return upper

    def _touch(self, node: _Node) -> None:
        stamp = next(self._clock)
        while node is not None:
            node.stamp = stamp
            node = node.parent

    def _walk(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    # -- public API --------------------------------------------------------

    def held_pages(self):
        """Every pool page a node holds, one yield per (node, page) ref —
        what the engine's page accounting sums against."""
        for node in self._walk():
            yield from node.pages

    def match(self, tokens, max_pages: int):
        """Longest cached page-granular prefix of ``tokens`` (capped at
        ``max_pages`` pages): ``(pages, node)``, the shared page ids in
        order and a handle whose path is LOCKED against eviction until
        ``unlock(node)``; ``([], None)`` on a miss. The caller retains any
        page it maps."""
        pages: list[int] = []
        node = self.root
        i = 0
        while max_pages > 0 and i + self.psz <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + self.psz]))
            if child is None:
                break
            m = self._match_edge(child, tokens, i, max_pages)
            if m == 0:
                break
            if m < len(child.pages):
                child = self._split(child, m)
            pages.extend(child.pages)
            node = child
            i += m * self.psz
            max_pages -= m
        if node is self.root:
            return [], None
        self._touch(node)
        self.lock(node)
        return pages, node

    def peek(self, tokens, max_pages: int) -> int:
        """Pages of the longest cached prefix of ``tokens`` (capped at
        ``max_pages``), read only: no locks, no LRU stamps, no splits."""
        node = self.root
        i = matched = 0
        while max_pages > 0 and i + self.psz <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + self.psz]))
            if child is None:
                break
            m = self._match_edge(child, tokens, i, max_pages)
            if m == 0:
                break
            matched += m
            i += m * self.psz
            max_pages -= m
            if m < len(child.pages):
                break   # the match ends inside this edge
            node = child
        return matched

    def lock(self, node: _Node) -> None:
        while node is not None:
            if node.lock == 0:
                self.locked_pages += len(node.pages)
            node.lock += 1
            node = node.parent

    def unlock(self, node: _Node) -> None:
        while node is not None:
            assert node.lock > 0
            node.lock -= 1
            if node.lock == 0:
                self.locked_pages -= len(node.pages)
            node = node.parent

    def insert(self, tokens, pages: list) -> int:
        """Cache ``pages`` (full pages backing ``tokens`` from position 0;
        ``len(tokens) == len(pages) * page_size``). Ranges the tree holds
        already keep their existing pages; novel pages are RETAINED (the
        tree takes its own ref), so the caller releases its refs on ALL of
        ``pages`` afterwards either way. Returns the pages newly added."""
        psz = self.psz
        assert len(tokens) == len(pages) * psz, (len(tokens), len(pages))
        node = self.root
        i = 0
        while i + psz <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + psz]))
            if child is None:
                break
            m = self._match_edge(child, tokens, i, len(pages) - i // psz)
            if m == 0:
                break
            if m < len(child.pages):
                child = self._split(child, m)
            node = child
            i += m * psz
        added = len(pages) - i // psz
        if added:
            key = tuple(tokens[i:])
            kept = pages[i // psz:]
            for p in kept:
                self.alloc.retain(p)
            leaf = _Node(key, list(kept), node)
            node.children[key[:psz]] = leaf
            node = leaf
            self.total_pages += added
            self._paths_version += 1
        self._touch(node)
        return added

    def token_paths(self, max_paths: int = 64):
        """Root-to-leaf token sequences currently cached, most recently
        used first (capped at ``max_paths``): the draft source of
        speculative decoding across requests (``infer/spec_decode.py``).
        Read only. Memoized between structural changes (insert, evict,
        clear), so the order within the memo window is the order at the
        last change, as in the JAX package."""
        if self._paths_cache is not None and self._paths_cache[0] == self._paths_version:
            return self._paths_cache[1]
        paths: list[tuple[int, tuple]] = []

        def walk(node: _Node, prefix: tuple) -> None:
            run = prefix + node.key
            if not node.children and run:
                paths.append((node.stamp, run))
                return
            for child in node.children.values():
                walk(child, run)

        walk(self.root, ())
        paths.sort(key=lambda sp: -sp[0])
        out = [p for _, p in paths[:max_paths]]
        self._paths_cache = (self._paths_version, out)
        return out

    def evictable_pages(self) -> int:
        """Pages reclaimable right now: every page in a subtree no live
        request has locked."""
        return self.total_pages - self.locked_pages

    def evict(self, n: int) -> int:
        """Free up to ``n`` pages back to the allocator, LRU-first at page
        granularity (trailing pages of the coldest unlocked leaf). Returns
        the pages freed."""
        psz = self.psz
        freed = 0
        while freed < n:
            leaves = [
                nd for nd in self._walk()
                if nd.lock == 0 and nd.pages and not nd.children
            ]
            if not leaves:
                break
            leaf = min(leaves, key=lambda nd: nd.stamp)
            first = leaf.key[:psz]
            while leaf.pages and freed < n:
                self.alloc.release(leaf.pages.pop())
                leaf.key = leaf.key[: len(leaf.pages) * psz]
                self.total_pages -= 1
                freed += 1
            if not leaf.pages:
                del leaf.parent.children[first]
        if freed:
            self._paths_version += 1
        return freed

    def clear(self) -> int:
        """Drop the whole cache (releases every tree-owned page ref);
        returns the pages released. Locked pages survive through their
        requests' refs, but their nodes are forgotten."""
        released = 0
        for node in self._walk():
            if node is self.root:
                continue
            for p in node.pages:
                self.alloc.release(p)
                released += 1
            # Orphaned nodes may still be unlocked later by live request
            # handles; empty page lists keep those walks no-ops.
            node.pages = []
        self.root = _Node((), [], None)
        self.total_pages = 0
        self.locked_pages = 0
        self._paths_version += 1
        self._paths_cache = None
        return released
