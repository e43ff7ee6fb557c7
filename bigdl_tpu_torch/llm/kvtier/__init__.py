"""The host KV tier — the port of ``bigdl_tpu/llm/kvtier``.

The capacity tier behind the prefix cache: radix-evicted full pages
spill to a host-RAM arena instead of being dropped, and an admission
whose prefix continues in the arena parks while a background migration
uploads those pages back, then adopts them like a device prefix hit:

- :mod:`~bigdl_tpu_torch.llm.kvtier.arena` — the host page arena
  (page-locked on a card), an exact token-prefix index, LRU within the
  tier;
- :mod:`~bigdl_tpu_torch.llm.kvtier.migrate` — the FIFO migration
  worker, its transfers on a side stream ordered by events; a failure
  degrades to a plain eviction or a plain miss;
- :mod:`~bigdl_tpu_torch.llm.kvtier.handoff` — KV-chain blobs that move
  a warm chain to another engine (the JAX package's wire format);
- :class:`KVTier` (here) — arena, migrator and the always-on tallies,
  held by the engine's :class:`~bigdl_tpu_torch.llm.kvcache.KVCacheManager`.

An engine built without ``kvtier=True`` makes none of this: no arena, no
thread, no ``tier`` block in ``debug_stats``, no ``bigdl_kvtier_*``
series. The tallies mirror into those series (``record_gauges`` for the
arena's fill and the migrations in flight) while observability is on,
and each spill is a flight-recorder ``spill`` event.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability import flight
from bigdl_tpu_torch.llm.kvtier.arena import HostArena, HostArenaError
from bigdl_tpu_torch.llm.kvtier.handoff import (HandoffError,
                                                deserialize_chain,
                                                serialize_chain)
from bigdl_tpu_torch.llm.kvtier.migrate import MigrationJob, Migrator


class KVTier:
    """Arena, migrator and tier tallies. Host-side only: every touch of
    the device pool goes through the reader and writer the engine hands
    the manager. ``device`` is the pool's: on a card the arena is
    page-locked and transfers ride the migrator's side stream."""

    def __init__(self, host_pages: int, page_size: int,
                 synchronous: bool = False, fetch_timeout: float = 30.0,
                 device=None):
        device = torch.device("cpu" if device is None else device)
        self.arena = HostArena(host_pages, page_size,
                               pin_memory=device.type == "cuda")
        self.migrator = Migrator(self.arena, synchronous=synchronous,
                                 device=device)
        self.fetch_timeout = fetch_timeout
        self.spills = 0
        self.fetches = 0
        self.fetch_failures = 0
        self.handoffs_out = 0
        self.handoffs_in = 0
        self.handoff_bytes = 0
        self._ins: Optional[Dict[str, Any]] = None

    # -- observability -------------------------------------------------------
    def _instruments(self):
        if not obs.enabled():
            return None
        if self._ins is None:
            self._ins = {
                "spills": obs.counter(
                    "bigdl_kvtier_spills_total",
                    "Pages spilled from HBM to the host arena"),
                "fetches": obs.counter(
                    "bigdl_kvtier_fetches_total",
                    "Pages fetched from the host arena back into HBM"),
                "fetch_failures": obs.counter(
                    "bigdl_kvtier_fetch_failures_total",
                    "Host-tier fetches that degraded to a cache miss"),
                "handoffs": obs.counter(
                    "bigdl_kvtier_handoffs_total",
                    "KV-chain handoffs across the prefill/decode split",
                    labelnames=("direction",)),
                "handoff_bytes": obs.counter(
                    "bigdl_kvtier_handoff_bytes_total",
                    "Serialized KV bytes moved by handoffs"),
                "host_used": obs.gauge(
                    "bigdl_kvtier_host_pages_used",
                    "Host arena slots currently holding a page"),
                "host_capacity": obs.gauge(
                    "bigdl_kvtier_host_pages",
                    "Host arena capacity in page slots"),
                "inflight": obs.gauge(
                    "bigdl_kvtier_inflight_migrations",
                    "Migration jobs queued or running"),
            }
        return self._ins

    def record_gauges(self):
        ins = self._instruments()
        if ins is None:
            return
        ins["host_used"].set(self.arena.used())
        ins["host_capacity"].set(self.arena.capacity)
        ins["inflight"].set(self.migrator.inflight())

    def count_spill(self, n: int = 1):
        self.spills += n
        flight.record("spill", pages=n)
        ins = self._instruments()
        if ins is not None:
            ins["spills"].inc(n)
            self.record_gauges()

    def count_fetch(self, n: int):
        self.fetches += n
        ins = self._instruments()
        if ins is not None:
            ins["fetches"].inc(n)
            self.record_gauges()

    def count_fetch_failure(self, n: int = 1):
        self.fetch_failures += n
        ins = self._instruments()
        if ins is not None:
            ins["fetch_failures"].inc(n)

    def count_handoff(self, direction: str, nbytes: int):
        if direction == "export":
            self.handoffs_out += 1
        else:
            self.handoffs_in += 1
        self.handoff_bytes += nbytes
        ins = self._instruments()
        if ins is not None:
            ins["handoffs"].labels(direction=direction).inc()
            ins["handoff_bytes"].inc(nbytes)

    def cancel_fetch(self, job: Optional[MigrationJob]):
        """Flag an in-flight fetch cancelled from outside the engine
        thread. Flag only: the worker still releases the arena pins, and
        the engine's next poll degrades the admission to a plain miss
        under its own lock."""
        if job is not None:
            job.cancelled = True

    def debug_stats(self) -> Dict[str, Any]:
        """The ``tier`` block of the manager's ``debug_stats``."""
        out = self.arena.stats()
        out.update({
            "spills": self.spills,
            "fetches": self.fetches,
            "fetch_failures": self.fetch_failures,
            "spill_failures": self.migrator.spill_failures,
            "inflight_migrations": self.migrator.inflight(),
            "handoffs_out": self.handoffs_out,
            "handoffs_in": self.handoffs_in,
            "handoff_bytes": self.handoff_bytes,
        })
        return out

    def close(self):
        self.migrator.stop()


__all__ = ["HandoffError", "HostArena", "HostArenaError", "KVTier",
           "MigrationJob", "Migrator", "deserialize_chain",
           "serialize_chain"]
