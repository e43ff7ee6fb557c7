"""Prefix-aware KV-cache subsystem — the port of
``bigdl_tpu/llm/kvcache/__init__.py``:

- :mod:`~bigdl_tpu_torch.llm.kvcache.pool` — refcounted page pool with
  pins and the admission-budget ledger;
- :mod:`~bigdl_tpu_torch.llm.kvcache.radix` — radix prefix index keyed
  on page-size token chunks, leaf-first LRU eviction;
- :mod:`~bigdl_tpu_torch.llm.kvcache.prefill` — the ragged in-place
  prefill helpers, the mixed prefill+decode step and the dense staging
  partial prefill;
- :class:`KVCacheManager` (here) — the engine-facing façade: admission
  lookup with suffix-only budget charging, adoption refcounts and pins,
  chunked admission's incremental charges, chain insertion at prefill
  and at EOS, LRU eviction on demand, and hit / miss / evict counters.

``enabled=False`` (the default) keeps the manager a pool wrapper: no
index, every admission charges the full worst case, and page ids flow
in the JAX engine's order.

Not ported here: the host KV tier (``attach_tier``, ``_spill``,
``materialize``, ``degrade``, the ``fetch*`` fields of
:class:`Admission`; ROADMAP Queue 1 item 6(f)), ``chain_locations`` (the
handoff export, 6(f)), and the ``kvcache.evict`` fault site and metric
instruments (reliability and observability, item 8).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from bigdl_tpu_torch.llm.kvcache.pool import PagePool, PagePoolError
from bigdl_tpu_torch.llm.kvcache.radix import PrefixMatch, RadixIndex


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class Admission:
    """One admitted request's cache grant, held per engine slot:
    ``charge`` the budget reservation (released wholesale at EOS);
    ``shared_pages`` the adopted full-prefix pages (one pool ref and a
    possibly shared pin each); ``tail_src`` the COW fork source when the
    match ended mid-page (a transient ref and pin, dropped once the
    prefill that copies it is dispatched)."""

    __slots__ = ("matched_len", "shared_pages", "tail_src", "tail_len",
                 "charge")

    def __init__(self, matched_len: int = 0,
                 shared_pages: Optional[List[int]] = None,
                 tail_src: Optional[int] = None, tail_len: int = 0,
                 charge: int = 0):
        self.matched_len = matched_len
        self.shared_pages = shared_pages or []
        self.tail_src = tail_src
        self.tail_len = tail_len
        self.charge = charge


class KVCacheManager:
    """Engine-facing façade over the pool and the radix index
    (thread-safe: ``submit`` peeks from client threads while the engine
    thread admits and releases)."""

    def __init__(self, num_pages: int, page_size: int,
                 enabled: bool = False):
        self.pool = PagePool(num_pages, page_size)
        self.page = page_size
        self.enabled = bool(enabled)
        self.index: Optional[RadixIndex] = (
            RadixIndex(self.pool) if self.enabled else None)
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefix_tokens_reused = 0

    # -- admission -----------------------------------------------------------
    def suffix_budget(self, prompt_len: int, max_new: int,
                      matched_len: int) -> int:
        """Worst-case pages the request may still need to OWN: every
        page from the first not fully shared one through the last decode
        token (a mid-page match's fork target included)."""
        return (_ceil_div(prompt_len + max_new, self.page)
                - matched_len // self.page)

    def peek(self, prompt_ids, max_new: int) -> Dict[str, int]:
        """Read-only suffix cost: no refs taken, no LRU touch, no
        counters."""
        with self._lock:
            matched = 0
            if self.enabled:
                m = self.index.lookup(prompt_ids, touch=False)
                matched = min(m.matched_len, len(prompt_ids) - 1)
            return {"pages_needed": self.suffix_budget(
                        len(prompt_ids), max_new, matched),
                    "pages_free": self.pool.budget_avail,
                    "matched_tokens": matched, "matched_device": matched}

    def admit(self, prompt_ids, max_new: int,
              chunk_pages: Optional[int] = None) -> Optional[Admission]:
        """Look up the longest cached prefix, charge the suffix-only
        budget (plus a pin for each newly adopted shared page), take the
        adoption refs and make the prompt's own pages allocatable
        (evicting if need be). None when the budget cannot cover it now
        (the engine's head-of-line wait).

        ``chunk_pages`` (chunked admission): charge only the first
        chunk's pages; later chunks extend the charge with
        :meth:`charge_chunk`, and the final one tops up the decode
        budget, so the sum equals the unchunked charge."""
        T = len(prompt_ids)
        with self._lock:
            if not self.enabled:
                charge = (chunk_pages if chunk_pages is not None
                          else self.suffix_budget(T, max_new, 0))
                if charge > self.pool.budget_avail:
                    return None
                self.pool.charge(charge)
                return Admission(charge=charge)
            m = self.index.lookup(prompt_ids)
            # a fully cached prompt still runs >= 1 suffix token: the
            # engine needs its logits to start decoding
            if m.matched_len > T - 1:
                m.matched_len = T - 1
                if m.tail_len > 1:
                    m.tail_len -= 1
                elif m.tail_len == 1:
                    m.tail_src, m.tail_len = None, 0
                else:
                    # a pure full-page match: its last page becomes a COW
                    # tail source missing its final slot
                    m.tail_src = m.full_pages.pop()
                    m.tail_len = self.page - 1
            if not m.tail_len:
                m.tail_src = None
            charge = (chunk_pages if chunk_pages is not None
                      else self.suffix_budget(T, max_new, m.matched_len))
            adopt = list(m.full_pages)
            if m.tail_src is not None:
                adopt.append(m.tail_src)
            if charge + self.pool.pin_cost(adopt) > self.pool.budget_avail:
                return None
            self.pool.charge(charge)
            for pid in adopt:
                self.pool.incref(pid)
                self.pool.pin(pid)
            adm = Admission(m.matched_len, m.full_pages, m.tail_src,
                            m.tail_len, charge)
            try:
                own_prompt = (chunk_pages if chunk_pages is not None
                              else _ceil_div(T, self.page)
                              - m.matched_len // self.page)
                self.ensure_free(own_prompt)
            except BaseException:
                self.cancel(adm)
                raise
            if m.matched_len:
                self.hits += 1
                self.prefix_tokens_reused += m.matched_len
            else:
                self.misses += 1
            return adm

    def cancel(self, adm: Admission):
        """Roll an admission back (a failed prefill): drop the adoption
        refs and pins and the budget charge."""
        with self._lock:
            self.release_transient(adm)
            for pid in adm.shared_pages:
                self.pool.decref(pid)
                self.pool.unpin(pid)
            adm.shared_pages = []
            self.pool.release(adm.charge)
            adm.charge = 0

    def charge_chunk(self, adm: Admission, n: int) -> bool:
        """Extend a chunked admission's charge by ``n`` pages (the next
        chunk's own pages, plus the decode top-up at the final chunk).
        False: the ledger cannot cover it now, nothing charged."""
        if n <= 0:
            return True
        with self._lock:
            if n > self.pool.budget_avail:
                return False
            self.pool.charge(n)
            adm.charge += n
            return True

    def uncharge_chunk(self, adm: Admission, n: int):
        """The exact inverse of :meth:`charge_chunk` (a chunk whose
        dispatch failed)."""
        if n <= 0:
            return
        with self._lock:
            self.pool.release(n)
            adm.charge -= n

    def release_transient(self, adm: Admission):
        """Drop the COW fork source's transient ref and pin, once the
        prefill that copies it is enqueued (stream order puts any later
        write of the page behind the copy)."""
        with self._lock:
            if adm.tail_src is not None:
                self.pool.decref(adm.tail_src)
                self.pool.unpin(adm.tail_src)
                adm.tail_src = None

    def release_slot(self, charge: int, owned, adopted=()):
        """EOS / rollback release: decrement refcounts instead of
        freeing — pages the index still references stay warm."""
        with self._lock:
            for pid in owned:
                self.pool.decref(pid)
            for pid in adopted:
                self.pool.decref(pid)
                self.pool.unpin(pid)
            self.pool.release(charge)

    # -- index maintenance ---------------------------------------------------
    def insert(self, tokens, pages):
        """Index a chain (the prompt at prefill; prompt + output at EOS);
        the index takes its own ref on each newly indexed page."""
        if not self.enabled or not len(tokens):
            return
        with self._lock:
            self.index.insert(tokens, pages)

    # -- physical pages ------------------------------------------------------
    def ensure_free(self, n: int):
        """Make ``n`` pages allocatable, LRU-evicting index-only chains
        under pool pressure."""
        with self._lock:
            short = n - self.pool.free_pages()
            if short <= 0:
                return
            if not self.enabled:
                raise PagePoolError(
                    "page shortage with the prefix cache disabled: the "
                    "admission budget should have prevented this")
            freed = self.index.evict_lru(short)
            self.evictions += len(freed)
            if len(freed) < short:
                raise PagePoolError(
                    f"eviction reclaimed {len(freed)}/{short} pages: the "
                    "pin/budget invariant is broken")

    def take_free(self) -> int:
        with self._lock:
            return self.pool.take_free()

    def alloc(self, n: int) -> List[int]:
        with self._lock:
            return self.pool.alloc(n)

    def free_owned(self, pages):
        with self._lock:
            for pid in pages:
                self.pool.decref(pid)

    # -- introspection -------------------------------------------------------
    @property
    def budget_avail(self) -> int:
        return self.pool.budget_avail

    def debug_stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"enabled": self.enabled, "page_size": self.page,
                   "num_pages": self.pool.num_pages,
                   "pages_free": self.pool.free_pages(),
                   "pages_allocated": self.pool.allocated(),
                   "pages_shared": self.pool.shared_pages(),
                   "pages_pinned": self.pool.pinned_pages(),
                   "budget_avail": self.pool.budget_avail,
                   "hits": self.hits, "misses": self.misses,
                   "evictions": self.evictions,
                   "prefix_tokens_reused": self.prefix_tokens_reused}
            if self.index is not None:
                out["index"] = self.index.stats()
            return out


__all__ = ["Admission", "KVCacheManager", "PagePool", "PagePoolError",
           "PrefixMatch", "RadixIndex"]
