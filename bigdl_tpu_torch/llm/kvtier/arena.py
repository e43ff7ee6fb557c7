"""The host-RAM page arena — the port of ``bigdl_tpu/llm/kvtier/arena.py``.

The capacity tier behind the prefix cache: page-granularity K/V copies
in two preallocated host tensors ``(capacity, L, Hkv, page, D)``, one a
side, allocated at the first page (so the host allocator never
fragments) and page-locked when the engine's pool lives on a card, so
the copies to and from the card are DMA transfers that can overlap
decode.

Entries are keyed by the FULL token prefix through the page
(``tuple(tokens[:end])``, the identity the radix tree encodes
path-wise); an exact-match dict keeps the tier robust to any insertion
order (chains spill back to front). Only full pages are admitted.
Thread-safe (its own lock): the engine thread reserves and looks up
while the migration thread commits and aborts. A **pin** keeps a
slot's bytes in place while a migration is in flight: a pinned slot is
never LRU-evicted and never handed to another key.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch


class HostArenaError(RuntimeError):
    """Internal-invariant violation (double commit, unpin underflow)."""


class HostArena:
    """Slot allocator and token-prefix index over the host page buffers.

    ``capacity`` is the number of page slots; the buffers' shape and
    dtype are the first page's. ``pin_memory`` page-locks them (an
    engine whose pool lives on a card)."""

    def __init__(self, capacity: int, page_size: int,
                 pin_memory: bool = False):
        if capacity < 1:
            raise ValueError("host arena needs at least one page slot")
        self.capacity = capacity
        self.page = page_size
        self.pin_memory = bool(pin_memory)
        self._lock = threading.Lock()
        # slot ids pop low first, like the device pool
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._index: Dict[Tuple[int, ...], int] = {}   # key -> slot
        self._slots: Dict[int, dict] = {}   # slot -> {key, ready, tick}
        self._pins: Dict[int, int] = {}
        self._tick = 0
        self._k: Optional[torch.Tensor] = None   # (capacity, L, H, page, D)
        self._v: Optional[torch.Tensor] = None
        self.host_evictions = 0
        self.bytes_per_page = 0
        self.alloc_seconds = 0.0     # the buffers' allocation (page-locking)

    # -- buffers -------------------------------------------------------------
    def _ensure_buffers(self, page_shape, dtype):
        if self._k is None:
            shape = (self.capacity,) + tuple(page_shape)
            t0 = time.perf_counter()
            # inference tensors: the engine thread and the migration
            # worker write them under inference mode
            with torch.inference_mode():
                self._k = torch.empty(shape, dtype=dtype,
                                      pin_memory=self.pin_memory)
                self._v = torch.empty(shape, dtype=dtype,
                                      pin_memory=self.pin_memory)
            self.alloc_seconds = time.perf_counter() - t0
            self.bytes_per_page = 2 * self._k[0].nbytes
        elif tuple(self._k.shape[1:]) != tuple(page_shape) or \
                self._k.dtype != dtype:
            raise HostArenaError(
                f"arena shaped {tuple(self._k.shape[1:])}/{self._k.dtype} "
                f"cannot hold a {tuple(page_shape)}/{dtype} page")

    @property
    def pinned_bytes(self) -> int:
        """Page-locked host bytes the buffers hold (0 before the first
        page, or unpinned)."""
        if self._k is None or not self.pin_memory:
            return 0
        return 2 * self._k.nbytes

    # -- allocation ----------------------------------------------------------
    def reserve(self, key: Tuple[int, ...]) -> Optional[int]:
        """Claim a slot for ``key`` (pinned, not yet readable): the spill
        and import side. An existing entry for the key is reused (the
        same tokens at the same positions hold the same KV). None when
        every slot is pinned: the caller drops the spill, which degrades
        to a plain eviction."""
        with self._lock:
            if len(key) % self.page:
                raise HostArenaError(
                    "arena holds full pages only (partial tails "
                    "re-prefill on miss)")
            slot = self._index.get(key)
            if slot is None:
                slot = self._take_slot_locked()
                if slot is None:
                    return None
                self._index[key] = slot
                self._slots[slot] = {"key": key, "ready": False,
                                     "tick": self._bump()}
            else:
                self._slots[slot]["ready"] = False
            self._pins[slot] = self._pins.get(slot, 0) + 1
            return slot

    def _take_slot_locked(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victim = None
        for slot, meta in self._slots.items():
            if slot in self._pins or not meta["ready"]:
                continue
            if victim is None or meta["tick"] < \
                    self._slots[victim]["tick"]:
                victim = slot
        if victim is None:
            return None
        self._drop_locked(victim)
        self.host_evictions += 1
        return self._free.pop()

    def _drop_locked(self, slot: int):
        meta = self._slots.pop(slot)
        self._index.pop(meta["key"], None)
        self._free.append(slot)

    def _bump(self) -> int:
        self._tick += 1
        return self._tick

    # -- migration-side writes -----------------------------------------------
    def slot_views(self, slot: int, page: torch.Tensor):
        """The ``(k, v)`` buffers of a reserved slot, made at the first
        page's shape and dtype: the migration worker copies a spilled
        page straight into them (the reserve pin keeps the slot theirs),
        then calls :meth:`commit` without pages."""
        with self._lock:
            if slot not in self._slots:
                raise HostArenaError(f"write of unreserved slot {slot}")
            self._ensure_buffers(page.shape, page.dtype)
            return self._k[slot], self._v[slot]

    def commit(self, slot: int, k_page: Optional[torch.Tensor] = None,
               v_page: Optional[torch.Tensor] = None):
        """Publish a reserved slot's bytes: write the pages (None: already
        written through :meth:`slot_views`), mark it ready, drop the
        reserve pin."""
        with self._lock:
            meta = self._slots.get(slot)
            if meta is None:
                raise HostArenaError(f"commit of unreserved slot {slot}")
            if k_page is not None:
                self._ensure_buffers(k_page.shape, k_page.dtype)
                with torch.inference_mode():
                    self._k[slot].copy_(k_page)
                    self._v[slot].copy_(v_page)
            elif self._k is None:
                raise HostArenaError(f"commit of unwritten slot {slot}")
            meta["ready"] = True
            meta["tick"] = self._bump()
            self._unpin_locked(slot)

    def abort(self, slot: int):
        """A reserved slot whose bytes never arrived (a failed spill):
        remove the entry, so no lookup serves an unwritten page."""
        with self._lock:
            if slot in self._slots and not self._slots[slot]["ready"]:
                self._unpin_locked(slot)
                if slot not in self._pins:
                    self._drop_locked(slot)
            elif slot in self._slots:
                self._unpin_locked(slot)

    # -- lookup / fetch side -------------------------------------------------
    def lookup_chunks(self, tokens, start: int, limit: int,
                      *, touch: bool = True
                      ) -> List[Tuple[Tuple[int, ...], int]]:
        """Consecutive READY full-page chunks of ``tokens`` in the arena,
        from position ``start`` (a page multiple), never past ``limit``
        tokens. ``[(key, slot), ...]`` in chain order."""
        toks = tuple(int(t) for t in tokens)
        out: List[Tuple[Tuple[int, ...], int]] = []
        with self._lock:
            end = start + self.page
            while end <= limit:
                slot = self._index.get(toks[:end])
                if slot is None or not self._slots[slot]["ready"]:
                    break
                out.append((toks[:end], slot))
                if touch:
                    self._slots[slot]["tick"] = self._bump()
                end += self.page
        return out

    def pin(self, slot: int):
        with self._lock:
            if slot not in self._slots:
                raise HostArenaError(f"pin of unknown slot {slot}")
            self._pins[slot] = self._pins.get(slot, 0) + 1

    def unpin(self, slot: int):
        with self._lock:
            self._unpin_locked(slot)

    def _unpin_locked(self, slot: int):
        c = self._pins.get(slot, 0)
        if c <= 0:
            raise HostArenaError(f"unpin of unpinned slot {slot}")
        if c == 1:
            del self._pins[slot]
        else:
            self._pins[slot] = c - 1

    def read(self, slot: int):
        """The slot's ``(k, v)`` page views; the caller holds a pin, so
        the slot is neither evicted nor rewritten mid-read."""
        with self._lock:
            meta = self._slots.get(slot)
            if meta is None or not meta["ready"]:
                raise HostArenaError(f"read of non-ready slot {slot}")
            return self._k[slot], self._v[slot]

    def read_keyed(self, slot: int, key: Tuple[int, ...]):
        """COPIES of a slot's pages if it still holds ``key``, else None
        (LRU may hand the slot to another chain between a lookup and
        this read); copied under the lock, so no pin is needed."""
        with self._lock:
            meta = self._slots.get(slot)
            if meta is None or not meta["ready"] or meta["key"] != key:
                return None
            return self._k[slot].clone(), self._v[slot].clone()

    def keys(self) -> List[Tuple[int, ...]]:
        """READY entry keys (full token prefixes)."""
        with self._lock:
            return [meta["key"] for meta in self._slots.values()
                    if meta["ready"]]

    # -- introspection -------------------------------------------------------
    def used(self) -> int:
        with self._lock:
            return len(self._slots)

    def pinned(self) -> int:
        with self._lock:
            return len(self._pins)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            ready = sum(1 for m in self._slots.values() if m["ready"])
            return {
                "capacity": self.capacity,
                "used": len(self._slots),
                "ready": ready,
                "pinned": len(self._pins),
                "evictions": self.host_evictions,
                "bytes_used": ready * self.bytes_per_page,
            }
