"""KV page pool — the port of ``bigdl_tpu/llm/kvcache/pool.py``, the
part the engine uses with the prefix cache disabled: the physical
free-id list and the admission budget. Shared pages (refcounts above
one, pins, copy-on-write) come with the radix prefix cache (ROADMAP
Queue 1 item 6(b)).

Two kinds of capacity, deliberately separate:

- **physical** pages — the free-id list. Ids pop low-first and frees
  append, the JAX engine's exact order, so the two allocate the same
  page ids for the same traffic.
- **budget** — the admission reservation counter (the worst-case
  reserve that makes decode deadlock-free). Reservations are
  bookkeeping only; they never touch the free list.

Page 0 is the engine's trash page (inactive rows dummy-write there) and
is never allocatable. Pure host-side bookkeeping.
"""

from __future__ import annotations

from typing import List, Set


class PagePoolError(RuntimeError):
    """Internal-invariant violation (double free, free-list underflow,
    budget overdraft)."""


class PagePool:
    """Page-id allocator over ``num_pages`` physical pages."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("pool needs at least one usable page "
                             "(page 0 is the reserved trash page)")
        self.num_pages = num_pages
        self.page_size = page_size
        # list(range(n-1, 0, -1)) popped from the end hands out page 1
        # first — the JAX engine's order
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._owned: Set[int] = set()
        self.budget_avail = num_pages - 1

    def free_pages(self) -> int:
        return len(self._free)

    def free_ids(self) -> List[int]:
        return self._free

    def take_free(self) -> int:
        """Pop one page. The caller reserved budget first — an empty list
        here is an accounting bug, not back-pressure."""
        if not self._free:
            raise PagePoolError(
                "free-list underflow: allocation outside the admission "
                "budget (reservation accounting is broken)")
        pid = self._free.pop()
        self._owned.add(pid)
        return pid

    def alloc(self, n: int) -> List[int]:
        return [self.take_free() for _ in range(n)]

    def decref(self, pid: int):
        """Drop the page's only reference; it returns to the free list
        (appended — the JAX engine's order)."""
        if pid not in self._owned:
            raise PagePoolError(f"decref of unallocated page {pid}")
        self._owned.remove(pid)
        self._free.append(pid)

    def charge(self, n: int):
        if n > self.budget_avail:
            raise PagePoolError(f"budget overdraft: charge {n} with "
                                f"{self.budget_avail} available")
        self.budget_avail -= n

    def release(self, n: int):
        self.budget_avail += n
        if self.budget_avail > self.num_pages - 1:
            raise PagePoolError("budget over-release")
