"""Asynchronous device<->host page migration — the port of
``bigdl_tpu/llm/kvtier/migrate.py``.

One background worker thread drains a FIFO of migration jobs, so the
waiting half of a transfer never runs on the engine thread:

- **spill**: at eviction the engine thread enqueues a copy of the page
  (``pool[:, pid].clone()``) on its own stream, ahead of any later
  reuse of the page id, and records an event behind it. The worker makes
  its side stream wait on that event, copies the page into the arena
  slot (``non_blocking``, into page-locked memory), synchronizes its
  stream and only then commits the slot.
- **fetch**: the worker uploads the arena pages to fresh device tensors
  on its side stream, records an event, waits for it and only then
  releases the slots' pins (an LRU re-key could otherwise overwrite the
  source of a copy still in flight). The engine makes its stream wait on
  the event before it scatters the pages into the pool.

The side stream is what lets a transfer overlap the engine's decode: a
worker that issued its copies on the default stream would serialize
with the engine's graph replays. On the CPU the same code runs with
plain copies and no stream. FIFO on one worker also orders a fetch
behind the spill that produced its bytes.

Failure contract, as the JAX package's: a failed spill aborts its arena
entry (the page is simply not cached); a failed fetch marks the job
failed and releases its pins, and the engine degrades the admission to
a plain cache miss. Nothing raises into the engine loop. The
``kvtier.spill`` / ``kvtier.fetch`` fault sites sit at the top of each
transfer, as in the JAX package, and a transfer that succeeds records a
``kvtier/migrate`` span.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, List, Optional, Tuple

import torch

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.llm.kvtier.arena import HostArena


class MigrationJob:
    """One queued migration. ``done`` is set exactly once, after ``ok``
    and the payload are final. ``cancelled`` (engine-set: a fetch
    timeout, an abort) tells the worker to skip the transfer; the arena
    pins are released either way. ``event`` marks a fetch's uploads on
    the worker's stream (None on the CPU)."""

    __slots__ = ("kind", "done", "ok", "error", "cancelled",
                 "entries", "k_dev", "v_dev", "event", "submitted_at")

    def __init__(self, kind: str, entries):
        self.kind = kind
        self.entries = entries        # [(key, slot, *payload)]
        self.done = threading.Event()
        self.ok = False
        self.error: Optional[str] = None
        self.cancelled = False
        self.k_dev: List[torch.Tensor] = []    # fetch results
        self.v_dev: List[torch.Tensor] = []
        self.event = None
        self.submitted_at = time.monotonic()


class Migrator:
    """The worker thread and its job queue. ``synchronous=True`` runs
    each job inline at submit (no thread): the deterministic tests use
    it. ``device`` is where fetched pages land (the engine's)."""

    def __init__(self, arena: HostArena, synchronous: bool = False,
                 device=None):
        self.arena = arena
        self.synchronous = synchronous
        self.device = torch.device("cpu" if device is None else device)
        self._stream = None           # the side stream, made at first use
        self._queue: "queue.Queue[Optional[MigrationJob]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()
        self._lock = threading.Lock()
        self._stopped = False
        self.spills_done = 0
        self.spill_failures = 0
        self.fetches_done = 0
        self.fetch_failures = 0
        # transfer time and bytes of the fetches (upload issue to its
        # completion on the side stream): their rate is bytes / seconds
        self.fetch_seconds = 0.0
        self.fetch_bytes = 0

    # -- submission ----------------------------------------------------------
    def _submit(self, job: MigrationJob) -> MigrationJob:
        if self.synchronous:
            self._run(job)
            return job
        with self._lock:
            if self._stopped:
                # a stopped migrator fails jobs instead of leaking pins
                self._resolve_pins(job)
                job.error = "migrator stopped"
                job.done.set()
                return job
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="bigdl-torch-kvtier-migrate",
                    daemon=True)
                self._thread.start()
            self._idle.clear()
        self._queue.put(job)
        return job

    def submit_spill(self, key, slot: int, k_dev, v_dev,
                     ready=None) -> MigrationJob:
        """Device to host. ``k_dev`` / ``v_dev`` are the engine's copies
        of the page, ``ready`` the event behind them on the engine's
        stream (None on the CPU); the arena slot is reserve-pinned."""
        return self._submit(
            MigrationJob("spill", [(key, slot, k_dev, v_dev, ready)]))

    def submit_fetch(self, entries: List[Tuple[Any, int]]) -> MigrationJob:
        """Host to device for a chain of ``(key, slot)`` arena chunks (the
        caller pinned each slot; the worker unpins when finished)."""
        return self._submit(MigrationJob("fetch", list(entries)))

    # -- worker --------------------------------------------------------------
    def _loop(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._run(job)
            finally:
                if self._queue.empty():
                    self._idle.set()

    def _side(self):
        """The worker's stream on a card (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _on(self, stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    def _run(self, job: MigrationJob):
        t0 = time.time()
        try:
            if job.cancelled:
                raise RuntimeError("cancelled before transfer")
            reliability.inject(f"kvtier.{job.kind}")
            with torch.inference_mode():
                if job.kind == "spill":
                    self._run_spill(job)
                else:
                    self._run_fetch(job)
            job.ok = True
        except Exception as e:  # noqa: BLE001 — a migration must degrade
            # (a miss, a plain eviction), never crash the worker
            job.error = f"{type(e).__name__}: {e}"
            if job.kind == "spill":
                self.spill_failures += 1
                for _, slot, *_ in job.entries:
                    try:
                        self.arena.abort(slot)
                    except Exception:   # noqa: BLE001 — best effort
                        pass
            else:
                self.fetch_failures += 1
                self._resolve_pins(job)
        finally:
            if job.ok:
                obs.add_complete(
                    "kvtier/migrate", t0, time.time() - t0,
                    direction=job.kind, pages=len(job.entries))
            job.done.set()

    def _run_spill(self, job: MigrationJob):
        side = self._side()
        for key, slot, k_dev, v_dev, ready in job.entries:
            k_host, v_host = self.arena.slot_views(slot, k_dev)
            with self._on(side):
                if ready is not None:
                    side.wait_event(ready)
                k_host.copy_(k_dev, non_blocking=True)
                v_host.copy_(v_dev, non_blocking=True)
            if side is not None:
                side.synchronize()      # the bytes are in the slot
            self.arena.commit(slot)
            self.spills_done += 1

    def _run_fetch(self, job: MigrationJob):
        side = self._side()
        t0 = time.perf_counter()
        try:
            with self._on(side):
                for key, slot in job.entries:
                    k_host, v_host = self.arena.read(slot)
                    job.k_dev.append(k_host.to(self.device, non_blocking=True,
                                               copy=True))
                    job.v_dev.append(v_host.to(self.device, non_blocking=True,
                                               copy=True))
                if side is not None:
                    job.event = torch.cuda.Event()
                    job.event.record(side)
            if job.event is not None:
                job.event.synchronize()
            self.fetch_seconds += time.perf_counter() - t0
            self.fetch_bytes += sum(t.nbytes for t in job.k_dev + job.v_dev)
            self.fetches_done += len(job.entries)
        finally:
            if side is not None:
                # a copy that failed part way may still be in flight: the
                # pins hold until the stream has finished with the slots
                side.synchronize()
            self._resolve_pins(job)

    def _resolve_pins(self, job: MigrationJob):
        if job.kind != "fetch":
            return
        for key, slot in job.entries:
            try:
                self.arena.unpin(slot)
            except Exception:   # noqa: BLE001 — best effort
                pass

    # -- lifecycle -----------------------------------------------------------
    def inflight(self) -> int:
        if self.synchronous:
            return 0
        return self._queue.qsize() + (0 if self._idle.is_set() else 1)

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for every queued job to finish (tests, ``stop``)."""
        if self.synchronous:
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.empty() and self._idle.is_set():
                return True
            time.sleep(0.002)
        return self._queue.empty() and self._idle.is_set()

    def stop(self, timeout: float = 5.0):
        self.drain(timeout)
        with self._lock:
            self._stopped = True
            thread, self._thread = self._thread, None
        if thread is not None:
            self._queue.put(None)
            thread.join(timeout=timeout)
