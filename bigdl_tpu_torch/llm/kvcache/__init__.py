"""KV-cache manager — the port of ``bigdl_tpu/llm/kvcache/__init__.py``'s
``KVCacheManager`` with the prefix cache DISABLED: a pool wrapper whose
admission charges the full worst case (prompt + ``max_new_tokens``) and
whose page ids flow in the JAX engine's order. The radix prefix index,
copy-on-write adoption, pins and the host tier are ROADMAP Queue 1 items
6(b) and 6(f).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from bigdl_tpu_torch.llm.kvcache.pool import PagePool, PagePoolError


class Admission:
    """One admitted request's cache grant: the budget ``charge``,
    released wholesale when the request finishes."""

    __slots__ = ("charge",)

    def __init__(self, charge: int):
        self.charge = charge


class KVCacheManager:
    """Engine-facing façade over the page pool (thread-safe: ``submit``
    peeks from client threads while the engine thread admits)."""

    def __init__(self, num_pages: int, page_size: int):
        self.pool = PagePool(num_pages, page_size)
        self.page = page_size
        self._lock = threading.RLock()

    def budget(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages a request may need to own."""
        return -(-(prompt_len + max_new) // self.page)

    def peek(self, prompt_ids, max_new: int) -> Dict[str, int]:
        with self._lock:
            return {"pages_needed": self.budget(len(prompt_ids), max_new),
                    "pages_free": self.pool.budget_avail}

    def admit(self, prompt_ids, max_new: int) -> Optional[Admission]:
        """Charge the worst-case budget, or return None when the pool
        cannot cover it now (the engine's head-of-line wait)."""
        with self._lock:
            charge = self.budget(len(prompt_ids), max_new)
            if charge > self.pool.budget_avail:
                return None
            self.pool.charge(charge)
            return Admission(charge)

    def cancel(self, adm: Admission):
        """Roll an admission back (a failed prefill)."""
        with self._lock:
            self.pool.release(adm.charge)
            adm.charge = 0

    def release_slot(self, charge: int, owned):
        """A finished request's pages return to the free list and its
        budget to the ledger."""
        with self._lock:
            for pid in owned:
                self.pool.decref(pid)
            self.pool.release(charge)

    def ensure_free(self, n: int):
        """With no prefix cache nothing is evictable: the admission
        budget guarantees ``n`` free pages, and a shortage is a bug."""
        if n > self.pool.free_pages():
            raise PagePoolError(
                "page shortage with the prefix cache disabled: the "
                "admission budget should have prevented this")

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

    @property
    def budget_avail(self) -> int:
        return self.pool.budget_avail


__all__ = ["Admission", "KVCacheManager", "PagePool", "PagePoolError"]
