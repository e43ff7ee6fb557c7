"""Refcounted KV page pool — the port of ``bigdl_tpu/llm/kvcache/pool.py``.

A page holding the KV of a shared prompt prefix is referenced by the
radix index AND by every live request that adopted it, so pages carry
refcounts and are freed only when the last reference drops.

Two kinds of capacity, deliberately separate:

- **physical** pages — the free-id list. Ids pop low-first and frees
  append, the JAX engine's exact order, so the two allocate the same
  page ids for the same traffic, and an engine with the prefix cache off
  allocates as the engine before the cache did.
- **budget** — the admission reservation counter (the worst-case
  reserve that makes decode deadlock-free). Reservations are
  bookkeeping only; they never touch the free list. With prefix reuse
  the engine charges only the uncached suffix plus one reservation per
  newly **pinned** shared page.

**Pinning.** An index-held page (refcount 1) is evictable and costs no
budget. Once a live request adopts it, it is unevictable and one page
of budget is reserved for it — once, however many requests share it
(``pin`` / ``unpin`` charge on the 0→1 and release on the 1→0
transition). So ``free + evictable`` always covers every remaining
reservation, and a charged request can always get its pages.

**Copy-on-write** is a refcount rule: a shared page (refcount > 1) is
never written in place; the engine forks an adopted partial tail page
into a page the request owns before its prefill writes (``prefill.py``
``fork_tail_pages``).

Page 0 is the engine's trash page (inactive rows dummy-write there) and
is never allocatable. Pure host-side bookkeeping.
"""

from __future__ import annotations

from typing import Dict, List


class PagePoolError(RuntimeError):
    """Internal-invariant violation (double free, free-list underflow,
    budget overdraft)."""


class PagePool:
    """Refcounted page-id allocator over ``num_pages`` physical pages.
    Not thread-safe by itself: the owning ``KVCacheManager`` serialises
    access."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("pool needs at least one usable page "
                             "(page 0 is the reserved trash page)")
        self.num_pages = num_pages
        self.page_size = page_size
        # list(range(n-1, 0, -1)) popped from the end hands out page 1
        # first — the JAX engine's order
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self.budget_avail = num_pages - 1
        # live-adopter counts of shared pages; each page with a nonzero
        # count holds exactly one budget reservation
        self._pins: Dict[int, int] = {}

    # -- physical pages ------------------------------------------------------
    def free_pages(self) -> int:
        return len(self._free)

    def free_ids(self) -> List[int]:
        return self._free

    def allocated(self) -> int:
        return len(self._ref)

    def take_free(self) -> int:
        """Pop one page (refcount 1). The caller reserved budget first —
        an empty list here is an accounting bug, not back-pressure."""
        if not self._free:
            raise PagePoolError(
                "free-list underflow: allocation outside the admission "
                "budget (reservation accounting is broken)")
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def alloc(self, n: int) -> List[int]:
        return [self.take_free() for _ in range(n)]

    def incref(self, pid: int) -> int:
        if pid not in self._ref:
            raise PagePoolError(f"incref of unallocated page {pid}")
        self._ref[pid] += 1
        return self._ref[pid]

    def decref(self, pid: int) -> int:
        """Drop one reference; at 0 the id returns to the free list
        (appended — the JAX engine's order)."""
        r = self._ref.get(pid)
        if r is None:
            raise PagePoolError(f"decref of unallocated page {pid}")
        if r == 1:
            del self._ref[pid]
            self._free.append(pid)
            return 0
        self._ref[pid] = r - 1
        return r - 1

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def shared_pages(self) -> int:
        """Pages referenced more than once."""
        return sum(1 for r in self._ref.values() if r > 1)

    # -- admission budget ----------------------------------------------------
    def charge(self, n: int):
        if n > self.budget_avail:
            raise PagePoolError(f"budget overdraft: charge {n} with "
                                f"{self.budget_avail} available")
        self.budget_avail -= n

    def release(self, n: int):
        self.budget_avail += n
        if self.budget_avail > self.num_pages - 1:
            raise PagePoolError("budget over-release")

    def pin(self, pid: int):
        """A live request adopted shared page ``pid``: reserve one page
        of budget on the first adopter only."""
        c = self._pins.get(pid, 0)
        if c == 0:
            self.charge(1)
        self._pins[pid] = c + 1

    def pin_cost(self, pids) -> int:
        """Reservations :meth:`pin` would newly take for ``pids``."""
        seen = set()
        cost = 0
        for pid in pids:
            if pid not in seen and self._pins.get(pid, 0) == 0:
                cost += 1
            seen.add(pid)
        return cost

    def pin_precharged(self, pid: int):
        """Pin consuming a reservation the caller already holds; if the
        page is pinned already, that reservation is surplus and goes
        back, so each pinned page keeps exactly one."""
        c = self._pins.get(pid, 0)
        if c != 0:
            self.release(1)
        self._pins[pid] = c + 1

    def unpin(self, pid: int):
        c = self._pins.get(pid, 0)
        if c <= 0:
            raise PagePoolError(f"unpin of unpinned page {pid}")
        if c == 1:
            del self._pins[pid]
            self.release(1)
        else:
            self._pins[pid] = c - 1

    def pinned_pages(self) -> int:
        return len(self._pins)

    # -- eviction support ----------------------------------------------------
    def evictable(self, pid: int) -> bool:
        """Only the index holds it: refcount exactly 1 and unpinned."""
        return self.refcount(pid) == 1 and pid not in self._pins
