"""Radix prefix index over the KV page pool — the port of
``bigdl_tpu/llm/kvcache/radix.py``.

Cached prefixes are a radix tree keyed on **token-id chunks of page
size**: an edge's key is the exact tuple of token ids one page holds,
and the node owns that page's id. Interior nodes are always full pages;
a node whose chunk is shorter than a page is a **tail**, the partly
filled last page of an indexed chain, adoptable by copy-on-write.

Lookup walks full chunks exactly, then scans the frontier's children
for the best partial overlap (>= 1 token): a divergent page still
donates its shared slots. Every traversed node is LRU-touched.

Eviction is leaf-first LRU: the least-recently-used leaf whose page
only the index references (``pool.evictable``) goes, and its page is
decref'd back to the free list; interior nodes become leaves as their
subtrees drain, so cold chains disappear back-to-front. The JAX index's
``spill=`` hook (the host KV tier, ROADMAP Queue 1 item 6(f)) is not
ported: passing one raises.

The index holds exactly one pool reference per node. Host-side only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.llm.kvcache.pool import PagePool


class RadixNode:
    __slots__ = ("chunk", "page", "children", "parent", "last_used")

    def __init__(self, chunk: Tuple[int, ...], page: Optional[int],
                 parent: Optional["RadixNode"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.last_used = 0


class PrefixMatch:
    """Result of :meth:`RadixIndex.lookup`: ``matched_len`` tokens;
    ``full_pages`` the page ids of the fully matched chunks;
    ``tail_src`` / ``tail_len`` the partly matched page (the COW fork
    source) when the match ends mid-page."""

    __slots__ = ("matched_len", "full_pages", "tail_src", "tail_len")

    def __init__(self, matched_len: int = 0,
                 full_pages: Optional[List[int]] = None,
                 tail_src: Optional[int] = None, tail_len: int = 0):
        self.matched_len = matched_len
        self.full_pages = full_pages or []
        self.tail_src = tail_src
        self.tail_len = tail_len


def _common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixIndex:
    """The prefix tree. Page references go through the shared
    :class:`PagePool`; hit / miss / evict accounting lives in the
    manager."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page = pool.page_size
        self.root = RadixNode((), None, None)
        self._tick = 0
        # flat registry for the LRU scans (bounded by the pool size)
        self._nodes: List[RadixNode] = []

    def __len__(self) -> int:
        return len(self._nodes)

    def indexed_pages(self) -> int:
        return len(self._nodes)

    def _touch(self, node: RadixNode):
        self._tick += 1
        while node is not None and node is not self.root:
            node.last_used = self._tick
            node = node.parent

    def lookup(self, tokens, *, touch: bool = True) -> PrefixMatch:
        """Longest cached prefix of ``tokens``: exact full-page chunks,
        then the best >= 1-token partial overlap among the frontier's
        children (ties go to the most recently used)."""
        toks = [int(t) for t in tokens]
        page = self.page
        node = self.root
        full_pages: List[int] = []
        i = 0
        while i + page <= len(toks):
            child = node.children.get(tuple(toks[i:i + page]))
            if child is None:
                break
            node = child
            full_pages.append(child.page)
            i += page
        rem = tuple(toks[i:])
        best: Optional[RadixNode] = None
        best_m = 0
        if rem:
            for child in node.children.values():
                m = _common_prefix(child.chunk, rem)
                if m > best_m or (m == best_m and best is not None
                                  and m and child.last_used
                                  > best.last_used):
                    best, best_m = child, m
        if touch:
            self._touch(best if best_m else node)
        if best_m:
            return PrefixMatch(i + best_m, full_pages, best.page, best_m)
        return PrefixMatch(i, full_pages)

    def insert(self, tokens, pages) -> List[int]:
        """Index ``tokens`` backed by ``pages`` (page ``j`` holds tokens
        ``[j*page, (j+1)*page)``; the last chunk may be partial). A chunk
        already indexed keeps its existing node and page (the duplicate
        frees at its owner's release). Returns the page ids newly
        referenced (one pool incref each)."""
        toks = [int(t) for t in tokens]
        page = self.page
        taken: List[int] = []
        node = self.root
        for j in range(0, len(toks), page):
            chunk = tuple(toks[j:j + page])
            pid = int(pages[j // page])
            child = node.children.get(chunk)
            if child is None:
                if pid == 0 or self.pool.refcount(pid) == 0:
                    break   # a trash or freed page is never indexed
                child = RadixNode(chunk, pid, node)
                node.children[chunk] = child
                self._nodes.append(child)
                self.pool.incref(pid)
                taken.append(pid)
            node = child
        self._touch(node)
        return taken

    def token_path(self, node: RadixNode) -> Tuple[int, ...]:
        """Every token from the root through ``node``'s chunk."""
        parts: List[Tuple[int, ...]] = []
        while node is not None and node is not self.root:
            parts.append(node.chunk)
            node = node.parent
        out: List[int] = []
        for chunk in reversed(parts):
            out.extend(chunk)
        return tuple(out)

    def leaf_paths(self) -> List[Tuple[int, ...]]:
        """Every leaf's full token path: the maximal chains indexed."""
        return [self.token_path(n) for n in self._nodes if not n.children]

    def evict_lru(self, n_pages: int, spill=None) -> List[int]:
        """Drop least-recently-used evictable leaves until ``n_pages``
        ids went back to the free list (or nothing evictable is left);
        returns them in eviction order.

        ``spill`` (the host tier) is called as ``spill(token_path,
        page_id)`` for each victim BEFORE its page is decref'd, while the
        id cannot be reissued; best effort (the manager's hook swallows
        its failures)."""
        freed: List[int] = []
        while len(freed) < n_pages:
            victim: Optional[RadixNode] = None
            for node in self._nodes:
                if node.children or not self.pool.evictable(node.page):
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            if spill is not None:
                spill(self.token_path(victim), victim.page)
            del victim.parent.children[victim.chunk]
            self._nodes.remove(victim)
            self.pool.decref(victim.page)
            freed.append(victim.page)
        return freed

    def stats(self) -> Dict[str, int]:
        leaves = sum(1 for n in self._nodes if not n.children)
        return {"nodes": len(self._nodes), "leaves": leaves,
                "tails": sum(1 for n in self._nodes
                             if len(n.chunk) < self.page)}
