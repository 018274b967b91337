"""Automatic prefix caching: a radix tree over token-id sequences whose
nodes own immutable, refcounted KV-cache pages, with an optional second
tier in host memory.

Counterpart of ``orion_tpu/infer/prefix_cache.py``, host tier included
(``HostPage``, ``peek_tiered``, ``demote``, ``evict_host``,
``promote_path``); ``token_paths`` feeds the speculative drafter. When a
request finishes or is preempted, the FULL pages of its context are
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
- Host tier (a ``HostPagePool`` and the engine's ``spill`` callback):
  eviction first DEMOTES pages, one batched device-to-host copy per sweep,
  and the tree entry becomes a ``HostPage`` marker holding the host slot.
  The tokens stay matchable; a later hit restores the bytes into fresh
  pool pages (the engine's one batched host-to-device copy) and
  ``promote_path`` flips the markers back to device ids. Within a node,
  device entries form a prefix and host entries a suffix. Discarding
  remains the fallback when the tier is absent, full, or the spill fails;
  with no host pool every path is the untiered tree's.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

from orion_tpu_torch.infer.kv_cache import HostPagePool, PageAllocator


class HostPage:
    """A tree page entry whose KV bytes live in the host tier: ``hid`` is
    the ``HostPagePool`` slot (the tree holds one ref on it). Appears in
    ``_Node.pages`` wherever a demoted page used to sit."""

    __slots__ = ("hid",)

    def __init__(self, hid: int):
        self.hid = hid

    def __repr__(self):  # debugging aid only
        return f"HostPage({self.hid})"


def _n_device(node: "_Node") -> int:
    """Device-resident entries in ``node.pages`` (they form a prefix)."""
    return sum(1 for p in node.pages if not isinstance(p, HostPage))


class _Node:
    """One radix-tree edge+node: ``key`` is the page-multiple token run on
    the edge INTO this node, ``pages`` the pool pages holding its KV."""

    __slots__ = ("key", "pages", "children", "parent", "lock", "stamp")

    def __init__(self, key: tuple, pages: list, parent: Optional["_Node"]):
        self.key = key                  # tuple[int, ...], len == len(pages)*psz
        self.pages = pages              # list[int] pool page ids
        # Children keyed by their edge's FIRST PAGE of tokens: siblings may
        # share a first token yet diverge inside the page, so a first-token
        # key would collide; a full first page is unique among siblings
        # (two edges sharing a whole page get merged by the split walk).
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.lock = 0                   # live requests at/below this node
        self.stamp = 0                  # LRU clock

    def __repr__(self):  # debugging aid only
        return (
            f"_Node(pages={self.pages}, lock={self.lock}, "
            f"children={len(self.children)})"
        )


class PrefixCache:
    """Host-side radix tree of cached KV pages (see module docstring)."""

    def __init__(
        self,
        page_size: int,
        alloc: PageAllocator,
        host_pool: Optional[HostPagePool] = None,
        spill: Optional[Callable[[list], Optional[list]]] = None,
    ):
        self.psz = page_size
        self.alloc = alloc
        # Host tier seam: ``spill(pages) -> hids | None`` is the engine's
        # batched d2h (alloc host slots, gather, device_get, store); None
        # means the copy could not happen and eviction falls back to
        # discarding. Both None => the tree behaves exactly as before.
        self.host_pool = host_pool
        self.spill = spill
        self.root = _Node((), [], None)
        self._clock = itertools.count(1)
        self.total_pages = 0            # DEVICE pages owned by the tree
        self.host_pages = 0             # HostPage entries (host slots held)
        # O(1) evictable accounting for the scheduler hot path: DEVICE
        # pages in nodes with lock > 0 (lock propagates to the root, so a
        # 0->1 / 1->0 transition during the lock/unlock walk pins/unpins
        # exactly that node's device pages). Kept in sync by lock/unlock/
        # insert/evict/clear/promote_path; splits move pages between
        # equal-lock nodes (no change). Host entries are never pool
        # headroom, so they are excluded throughout.
        self.locked_pages = 0
        # token_paths() memo: the path SET only changes on insert/evict/
        # clear (splits preserve it), so the speculative proposer's
        # per-step read is amortized to a dict lookup between mutations.
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
        node. ``node`` keeps the lower part (so existing handles held by
        lockers stay valid) and the upper inherits the lock count — every
        locker of the lower part pins the whole edge."""
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
        """Every DEVICE pool page a cache node currently holds, one yield
        per (node, page) reference — the public accounting surface the
        engine's pool invariant (assert_page_accounting) sums against,
        so refcount checks never couple to the tree's internals."""
        for node in self._walk():
            for p in node.pages:
                if not isinstance(p, HostPage):
                    yield p

    def held_host_pages(self):
        """Every host-tier slot a cache node currently holds, one yield
        per (node, HostPage) reference — the host half of the accounting
        surface (each yield is one tree ref on that ``HostPagePool``
        slot)."""
        for node in self._walk():
            for p in node.pages:
                if isinstance(p, HostPage):
                    yield p.hid

    def match(self, tokens, max_pages: int):
        """Longest cached page-granular prefix of ``tokens`` (capped at
        ``max_pages`` pages). Returns ``(pages, node)``: the shared page
        ids in order and a handle pinning them — the matched path is
        LOCKED against eviction until ``unlock(node)``. ``(([], None))``
        on a miss. The caller must ``alloc.retain`` any page it maps.

        With a host tier attached, entries may be ``HostPage`` markers:
        the tokens matched but the bytes live in host RAM. The engine
        either restores them (``promote_path`` flips the markers to fresh
        device ids under this match's lock) or unlocks and re-matches
        capped at the first host entry — it never maps a marker."""
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
        """Pages of the longest cached page-granular prefix of ``tokens``
        (capped at ``max_pages``) — the READ-ONLY twin of ``match()``:
        no locks taken, no LRU stamps touched, no edge splits. The
        multi-replica router probes every replica's tree per placement
        (the JAX package's router), and a probe must never mutate
        a tree it then routes AWAY from."""
        return self.peek_tiered(tokens, max_pages)[0]

    def peek_tiered(self, tokens, max_pages: int) -> tuple[int, int, int]:
        """Read-only tiered probe: ``(matched, host, first_host)`` where
        ``matched`` is ``peek()``'s page count, ``host`` how many of those
        entries are host-resident, and ``first_host`` the flat index of
        the first host entry (== ``matched`` when the whole match is
        device-resident). The router's affinity probe uses this so a
        replica holding the prefix only in host RAM still advertises the
        match — host-warm beats cold — while the engine's own probe can
        apply the break-even threshold to the host span."""
        node = self.root
        i = 0
        matched = 0
        host = 0
        first_host = -1
        while max_pages > 0 and i + self.psz <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + self.psz]))
            if child is None:
                break
            m = self._match_edge(child, tokens, i, max_pages)
            if m == 0:
                break
            for k in range(m):
                if isinstance(child.pages[k], HostPage):
                    host += 1
                    if first_host < 0:
                        first_host = matched + k
            matched += m
            i += m * self.psz
            max_pages -= m
            if m < len(child.pages):
                break   # match ends inside this edge: nothing deeper
            node = child
        if first_host < 0:
            first_host = matched
        return matched, host, first_host

    def lock(self, node: _Node) -> None:
        while node is not None:
            if node.lock == 0:
                self.locked_pages += _n_device(node)
            node.lock += 1
            node = node.parent

    def unlock(self, node: _Node) -> None:
        while node is not None:
            assert node.lock > 0
            node.lock -= 1
            if node.lock == 0:
                self.locked_pages -= _n_device(node)
            node = node.parent

    def insert(self, tokens, pages: list) -> int:
        """Cache ``pages`` (full pages backing ``tokens``, contiguous from
        position 0; ``len(tokens) == len(pages) * page_size``). Ranges the
        tree already holds are deduplicated in favor of the existing
        pages; novel pages are RETAINED (the tree takes its own ref), so
        the caller releases its refs on ALL of ``pages`` afterwards either
        way. Returns the number of pages newly added."""
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
        used first (capped at ``max_paths``). Draft source for
        speculative decoding (infer/spec_decode.py): a cached
        system-prompt + answer path predicts continuations for requests
        sharing the prefix, so the n-gram proposer can draft across
        requests, not just from a request's own history. Read-only — no
        locks taken, no stamps touched. Memoized between structural
        mutations (insert/evict/clear), so the per-decode-step call costs
        a version check, not a tree walk; recency ORDER within the memo
        window is the mutation-time order, which is draft-priority
        fidelity enough for a fallback source."""
        if (
            self._paths_cache is not None
            and self._paths_cache[0] == self._paths_version
        ):
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
        """Device pages reclaimable right now: every device page in a
        subtree no live request has locked. O(1) — the scheduler consults
        this once per admission candidate per step (locks propagate to
        the root, so the locked/unlocked page split is maintained
        incrementally)."""
        return self.total_pages - self.locked_pages

    def evict(self, n: int) -> int:
        """Free up to ``n`` device pages back to the allocator, LRU-first
        at page granularity. With a host tier attached the pages are
        DEMOTED (bytes spilled to host RAM, tokens stay matchable) before
        any are discarded outright; without one — or when the spill
        fails — eviction discards exactly as before. Returns the number
        of device pages actually freed either way."""
        freed = self.demote(n) if (
            self.host_pool is not None and self.spill is not None
        ) else 0
        if freed < n:
            freed += self._discard(n - freed)
        return freed

    def demote(self, n: int) -> int:
        """Move up to ``n`` of the coldest unlocked device pages to the
        host tier: ONE ``spill`` callback copies their bytes (the batched
        d2h lives engine-side), then each tree entry flips to a
        ``HostPage`` marker and the device page returns to the allocator.
        Trailing device entries of the coldest nodes go first — stamps
        propagate to the root, so descendants demote before ancestors and
        every node keeps its device-prefix/host-suffix shape. Token paths
        are unchanged (no ``_paths_version`` bump: the same sequences
        still match). Returns device pages freed; 0 when the tier is
        absent, out of room after its own LRU eviction, or the spill
        declines."""
        hp = self.host_pool
        if hp is None or self.spill is None or n <= 0:
            return 0
        if hp.free_slots < n:
            self.evict_host(n - hp.free_slots)
        want = min(n, hp.free_slots)
        if want <= 0:
            return 0
        victims: list[tuple[_Node, int, int]] = []
        nodes = sorted(
            (
                nd for nd in self._walk()
                if nd is not self.root and nd.lock == 0
            ),
            key=lambda nd: nd.stamp,
        )
        for nd in nodes:
            for idx in range(_n_device(nd) - 1, -1, -1):
                victims.append((nd, idx, nd.pages[idx]))
                if len(victims) == want:
                    break
            if len(victims) == want:
                break
        if not victims:
            return 0
        hids = self.spill([p for _, _, p in victims])
        if hids is None:
            return 0
        assert len(hids) == len(victims), (len(hids), len(victims))
        for (nd, idx, page), hid in zip(victims, hids):
            nd.pages[idx] = HostPage(hid)
            self.alloc.release(page)
            self.total_pages -= 1
            self.host_pages += 1
        return len(victims)

    def evict_host(self, n: int) -> int:
        """Free up to ``n`` host-tier slots, LRU-first: trailing
        ``HostPage`` entries of the least-recently-used unlocked leaves
        are dropped (their tokens stop matching — this is the tier's own
        capacity eviction, the end of the line for those bytes). Stops at
        a device entry: host entries are always the suffix, so the trim
        never strands a device page behind a hole. Returns slots freed."""
        psz = self.psz
        freed = 0
        while freed < n:
            leaves = [
                nd for nd in self._walk()
                if nd.lock == 0 and nd.pages and not nd.children
                and isinstance(nd.pages[-1], HostPage)
            ]
            if not leaves:
                break
            leaf = min(leaves, key=lambda nd: nd.stamp)
            first = leaf.key[:psz]
            while (
                leaf.pages and freed < n
                and isinstance(leaf.pages[-1], HostPage)
            ):
                entry = leaf.pages.pop()
                leaf.key = leaf.key[: len(leaf.pages) * psz]
                self.host_pool.release(entry.hid)
                self.host_pages -= 1
                freed += 1
            if not leaf.pages:
                del leaf.parent.children[first]
        if freed:
            self._paths_version += 1
        return freed

    def _discard(self, n: int) -> int:
        """Free up to ``n`` device pages by dropping LRU leaf tails
        outright — the untiered eviction path, byte-identical to the
        pre-tier ``evict``. Host entries encountered on the way out (the
        leaf's suffix pops first) release their slots without counting
        toward ``n``: a discarded token range must not leave orphaned
        host bytes behind."""
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
                page = leaf.pages.pop()
                leaf.key = leaf.key[: len(leaf.pages) * psz]
                if isinstance(page, HostPage):
                    self.host_pool.release(page.hid)
                    self.host_pages -= 1
                else:
                    self.alloc.release(page)
                    self.total_pages -= 1
                    freed += 1
            if not leaf.pages:
                del leaf.parent.children[first]
        if freed:
            self._paths_version += 1
        return freed

    def promote_path(self, node: _Node, new_pages: dict) -> None:
        """Flip restored entries on the root->``node`` path from
        ``HostPage`` markers back to device page ids. ``new_pages`` maps
        flat match indices (positions in the page list ``match()``
        returned) to freshly-allocated device pages whose bytes the
        engine has already scattered in. Must be called under the match's
        lock: every mutation path (demote / evict_host / _discard /
        clear-then-orphan) skips locked nodes, so the path cannot have
        shifted since the match. The tree's host-slot refs are released
        here; the engine releases its own in-flight refs separately."""
        path: list[_Node] = []
        nd = node
        while nd is not None and nd is not self.root:
            path.append(nd)
            nd = nd.parent
        path.reverse()
        done = 0
        i = 0
        for nd in path:
            for j in range(len(nd.pages)):
                if i in new_pages:
                    entry = nd.pages[j]
                    assert isinstance(entry, HostPage), (i, entry)
                    nd.pages[j] = new_pages[i]
                    self.host_pool.release(entry.hid)
                    self.host_pages -= 1
                    self.total_pages += 1
                    if nd.lock > 0:
                        self.locked_pages += 1
                    done += 1
                i += 1
        assert done == len(new_pages), (done, sorted(new_pages))

    def clear(self) -> int:
        """Drop the whole cache (releases every tree-owned page ref, both
        tiers); returns the number of DEVICE pages released. Locked pages
        survive via their requests' refs but their nodes are forgotten."""
        released = 0
        for node in self._walk():
            if node is self.root:
                continue
            for p in node.pages:
                if isinstance(p, HostPage):
                    self.host_pool.release(p.hid)
                else:
                    self.alloc.release(p)
                    released += 1
            # Orphaned nodes may still be unlocked later by live request
            # handles; empty page lists keep those walks (and the
            # locked_pages accounting) no-ops.
            node.pages = []
        self.root = _Node((), [], None)
        self.total_pages = 0
        self.locked_pages = 0
        self.host_pages = 0
        self._paths_version += 1
        self._paths_cache = None
        return released
