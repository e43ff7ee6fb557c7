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
in the JAX engine's order. With the host tier attached
(:meth:`KVCacheManager.attach_tier`, ``bigdl_tpu_torch/llm/kvtier``),
evicted full pages spill to the host arena, an admission extends its
match with the arena chunks that continue it and parks while they
upload (:meth:`~KVCacheManager.materialize` lands them, and
:meth:`~KVCacheManager.degrade` turns a failed fetch into a plain miss),
and :meth:`~KVCacheManager.chain_locations` walks a chain across both
tiers for the handoff export.

The tallies mirror into the ``bigdl_kvcache_*`` series (and the gauges
``record_gauges`` sets) while the cache is on and observability
records; each eviction is a flight-recorder ``evict`` event, and the
``kvcache.evict`` fault site fires before eviction mutates anything, so
an injected raise is cleanly retryable.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.llm.kvcache.pool import PagePool, PagePoolError
from bigdl_tpu_torch.observability import flight
from bigdl_tpu_torch.llm.kvcache.radix import PrefixMatch, RadixIndex


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class Admission:
    """One admitted request's cache grant, held per engine slot:
    ``charge`` the budget reservation (released wholesale at EOS);
    ``shared_pages`` the adopted full-prefix pages (one pool ref and a
    possibly shared pin each); ``tail_src`` the COW fork source when the
    match ended mid-page (a transient ref and pin, dropped once the
    prefill that copies it is dispatched).

    Host tier: when the match continues in the host arena, ``fetch``
    names its ``(key, slot)`` chunks, ``fetch_job`` the migration
    uploading them and ``fetch_reserved`` the budget pre-charged for
    their pool pages. ``matched_len`` already includes them; a failed
    fetch rolls it back to ``device_matched`` (:meth:`KVCacheManager.
    degrade`) and the pre-charge becomes plain suffix budget."""

    __slots__ = ("matched_len", "shared_pages", "tail_src", "tail_len",
                 "charge", "fetch", "fetch_job", "fetch_reserved",
                 "device_matched")

    def __init__(self, matched_len: int = 0,
                 shared_pages: Optional[List[int]] = None,
                 tail_src: Optional[int] = None, tail_len: int = 0,
                 charge: int = 0):
        self.matched_len = matched_len
        self.shared_pages = shared_pages or []
        self.tail_src = tail_src
        self.tail_len = tail_len
        self.charge = charge
        self.fetch: List[Any] = []
        self.fetch_job = None
        self.fetch_reserved = 0
        self.device_matched = matched_len


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
        # the host tier and the engine's page reader / writer, set by
        # attach_tier; None leaves every tier branch below out
        self.tier = None
        self._read_page = None
        self._write_pages = None
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefix_tokens_reused = 0
        self._ins: Optional[Dict[str, Any]] = None

    # -- observability -------------------------------------------------------
    def _instruments(self):
        if not (self.enabled and obs.enabled()):
            return None
        if self._ins is None:
            self._ins = {
                "hits": obs.counter(
                    "bigdl_kvcache_hits_total",
                    "Admissions that reused a cached prefix"),
                "misses": obs.counter(
                    "bigdl_kvcache_misses_total",
                    "Admissions with no cached prefix"),
                "evictions": obs.counter(
                    "bigdl_kvcache_evictions_total",
                    "Pages evicted from the prefix index under pool "
                    "pressure"),
                "reused": obs.counter(
                    "bigdl_kvcache_prefix_tokens_reused_total",
                    "Prompt tokens served from cached prefixes instead "
                    "of prefill"),
                "indexed": obs.gauge(
                    "bigdl_kvcache_indexed_pages",
                    "Pages currently referenced by the prefix index"),
                "shared": obs.gauge(
                    "bigdl_kvcache_shared_pages",
                    "Pages with more than one reference (index + live "
                    "requests)"),
                "occupancy": obs.gauge(
                    "bigdl_kvcache_pool_occupancy",
                    "Fraction of the usable page pool allocated "
                    "(live + indexed)"),
            }
        return self._ins

    def record_gauges(self):
        ins = self._instruments()
        if ins is None:
            return
        ins["indexed"].set(self.index.indexed_pages())
        ins["shared"].set(self.pool.shared_pages())
        ins["occupancy"].set(
            self.pool.allocated() / max(self.pool.num_pages - 1, 1))
        if self.tier is not None:
            self.tier.record_gauges()

    def _count(self, name: str, n: int = 1):
        ins = self._instruments()
        if ins is not None:
            ins[name].inc(n)

    # -- host tier -----------------------------------------------------------
    def attach_tier(self, tier, reader, writer):
        """Arm the host tier. ``reader(pid)`` enqueues a copy of one page
        of the engine's pools and returns ``(k, v, ready)``, ``ready``
        the event behind the copy (None on the CPU); engine thread only,
        so the copy is enqueued before any later reuse of the id.
        ``writer(pids, k_devs, v_devs, ready)`` writes fetched pages into
        the pools in place."""
        if not self.enabled:
            raise ValueError(
                "the host tier extends the prefix cache: enable "
                "bigdl.llm.kvcache first")
        self.tier = tier
        self._read_page = reader
        self._write_pages = writer

    def _spill(self, token_path, pid: int):
        """Eviction hook: send the page to the host arena before its id is
        freed. Best effort: any failure (every slot pinned, a failed
        copy) leaves the eviction a plain drop."""
        if len(token_path) % self.page:
            return              # partial tails prefill again on a miss
        key = tuple(token_path)
        slot = self.tier.arena.reserve(key)
        if slot is None:
            return              # every slot pinned: skip this spill
        try:
            self.tier.migrator.submit_spill(key, slot, *self._read_page(pid))
        except Exception:  # noqa: BLE001 — a spill is an optimisation
            self.tier.arena.abort(slot)     # no reserved slot left behind
            return
        self.tier.count_spill()

    def materialize(self, adm: Admission, k_devs, v_devs, ready=None):
        """Land a completed fetch: take pool pages (evicting if need be),
        write the uploaded pages into them (``ready``: the uploads'
        event), index the chunks and turn the admission's pre-charge
        into ordinary pinned adoption. After this the admission is a
        device prefix hit."""
        with self._lock:
            n = len(adm.fetch)
            if n == 0:
                return
            self.ensure_free(n)
            pids = [self.pool.take_free() for _ in range(n)]
            self._write_pages(pids, k_devs, v_devs, ready)
            # index under the chain's identity: the device-matched chunks
            # keep their nodes, the fetched ones take one index ref each;
            # a chunk indexed meanwhile by another request keeps its page
            # and ours stays request-private (freed at EOS)
            chain = list(adm.fetch[-1][0])
            self.index.insert(chain, list(adm.shared_pages) + pids)
            for pid in pids:
                # take_free's ref becomes the adoption ref; the pin uses
                # the admission's pre-charge
                self.pool.pin_precharged(pid)
            adm.shared_pages.extend(pids)
            adm.fetch_reserved = 0
            adm.fetch = []
            adm.fetch_job = None
            self.prefix_tokens_reused += n * self.page
            self._count("reused", n * self.page)
            self.tier.count_fetch(n)
            self.record_gauges()

    def degrade(self, adm: Admission):
        """A failed, timed-out or cancelled fetch becomes a plain miss:
        the match rolls back to its device part and the pre-charge turns
        1:1 into the suffix budget of the extra prefill pages (the arena
        pins are the worker's to release)."""
        with self._lock:
            if not adm.fetch:
                return
            if adm.fetch_job is not None:
                adm.fetch_job.cancelled = True
            adm.charge += adm.fetch_reserved
            adm.fetch_reserved = 0
            adm.fetch = []
            adm.fetch_job = None
            adm.matched_len = adm.device_matched
            adm.tail_src, adm.tail_len = None, 0
            self.tier.count_fetch_failure()

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
        counters. Host-resident chunks cut the prefill, not the budget
        (each fetched page pre-charges a page): ``matched_tokens``
        counts them, ``matched_device`` and ``pages_needed`` do not."""
        with self._lock:
            matched = matched_total = 0
            if self.enabled:
                m = self.index.lookup(prompt_ids, touch=False)
                matched = matched_total = min(m.matched_len,
                                              len(prompt_ids) - 1)
                if self.tier is not None:
                    base = len(m.full_pages) * self.page
                    host = self.tier.arena.lookup_chunks(
                        prompt_ids, base, len(prompt_ids) - 1, touch=False)
                    if host:
                        matched = base
                        matched_total = base + len(host) * self.page
            return {"pages_needed": self.suffix_budget(
                        len(prompt_ids), max_new, matched),
                    "pages_free": self.pool.budget_avail,
                    "matched_tokens": matched_total,
                    "matched_device": matched}

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
        budget, so the sum equals the unchunked charge. The host tier is
        bypassed in this mode.

        With the host tier, arena chunks continuing the device's full
        pages extend the match (a host chunk beats a device tail, so the
        tail is dropped); each pre-charges the pool page it will take,
        and the admission comes back with ``fetch`` armed and its upload
        submitted."""
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
            host_chunks = []
            if self.tier is not None and chunk_pages is None:
                base = len(m.full_pages) * self.page
                host_chunks = self.tier.arena.lookup_chunks(
                    prompt_ids, base, T - 1)
                if host_chunks:
                    m.matched_len = base + len(host_chunks) * self.page
                    m.tail_src, m.tail_len = None, 0
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
            n_fetch = len(host_chunks)
            charge = (chunk_pages if chunk_pages is not None
                      else self.suffix_budget(T, max_new, m.matched_len))
            adopt = list(m.full_pages)
            if m.tail_src is not None:
                adopt.append(m.tail_src)
            if charge + n_fetch + self.pool.pin_cost(adopt) > \
                    self.pool.budget_avail:
                return None
            self.pool.charge(charge + n_fetch)
            for pid in adopt:
                self.pool.incref(pid)
                self.pool.pin(pid)
            adm = Admission(m.matched_len, m.full_pages, m.tail_src,
                            m.tail_len, charge)
            adm.fetch_reserved = n_fetch
            adm.device_matched = (len(m.full_pages) * self.page
                                  if host_chunks else m.matched_len)
            try:
                own_prompt = (chunk_pages if chunk_pages is not None
                              else _ceil_div(T, self.page)
                              - m.matched_len // self.page)
                self.ensure_free(own_prompt)
            except BaseException:
                self.cancel(adm)
                raise
            # arm the fetch last: nothing below raises, so cancel() never
            # races the worker's arena unpins
            if host_chunks:
                for _key, slot in host_chunks:
                    self.tier.arena.pin(slot)
                adm.fetch = host_chunks
                adm.fetch_job = self.tier.migrator.submit_fetch(host_chunks)
            if m.matched_len:
                # host tokens count as reused only once their fetch lands
                self.hits += 1
                self.prefix_tokens_reused += adm.device_matched
                self._count("hits")
                if adm.device_matched:
                    self._count("reused", adm.device_matched)
            else:
                self.misses += 1
                self._count("misses")
            return adm

    def cancel(self, adm: Admission):
        """Roll an admission back (a failed prefill, an abort, a stop with
        its fetch still parked): drop the adoption refs and pins, the
        budget charge and any fetch pre-charge. The arena pins are the
        worker's: cancelling the job makes it release them."""
        with self._lock:
            self.release_transient(adm)
            for pid in adm.shared_pages:
                self.pool.decref(pid)
                self.pool.unpin(pid)
            adm.shared_pages = []
            if adm.fetch_job is not None:
                adm.fetch_job.cancelled = True
            self.pool.release(adm.charge + adm.fetch_reserved)
            adm.charge = 0
            adm.fetch_reserved = 0
            adm.fetch = []
            adm.fetch_job = None

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
            self.record_gauges()

    def chain_locations(self, tokens):
        """Where a chain's cached FULL pages live now (the handoff
        export's walk): device page ids of the radix-resident prefix,
        then the ``(key, slot)`` arena chunks continuing it."""
        with self._lock:
            m = self.index.lookup(tokens)
            dev = list(m.full_pages)
            host = []
            if self.tier is not None:
                host = self.tier.arena.lookup_chunks(
                    tokens, len(dev) * self.page, len(tokens))
            return dev, host

    # -- physical pages ------------------------------------------------------
    def ensure_free(self, n: int):
        """Make ``n`` pages allocatable, LRU-evicting index-only chains
        under pool pressure (each evicted full page offered to the host
        tier first). The ``kvcache.evict`` fault site fires before any
        mutation, so an injected raise is cleanly retryable."""
        with self._lock:
            short = n - self.pool.free_pages()
            if short <= 0:
                return
            if not self.enabled:
                raise PagePoolError(
                    "page shortage with the prefix cache disabled: the "
                    "admission budget should have prevented this")
            reliability.inject("kvcache.evict")
            freed = self.index.evict_lru(
                short, spill=self._spill if self.tier is not None else None)
            self.evictions += len(freed)
            self._count("evictions", len(freed))
            if freed:
                flight.record("evict", pages=len(freed), requested=short)
            self.record_gauges()
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
            if self.tier is not None:
                out["tier"] = self.tier.debug_stats()
            return out


__all__ = ["Admission", "KVCacheManager", "PagePool", "PagePoolError",
           "PrefixMatch", "RadixIndex"]
