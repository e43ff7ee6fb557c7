"""Per-process elastic agent — the port of ``bigdl_tpu/elastic/agent.py``.

One :class:`ElasticAgent` runs beside each training process. It owns two
concerns the optimizer loop must never block on:

- **peer heartbeats** — a background thread posts this process's step
  and snapshot progress to the supervisor every
  ``bigdl.elastic.heartbeat.interval`` seconds and applies the
  directives that ride back: ``committed_step`` commits the local
  :class:`~bigdl_tpu_torch.elastic.snapshot.SnapshotRing`, ``abort``
  arms the abort flag the optimizer checks at each iteration boundary.
- **the collective-hang watchdog** — the engine-watchdog pattern applied
  to the optimizer loop: the loop refreshes a step heartbeat at the top
  of every iteration (:meth:`step_heartbeat`), so a heartbeat older than
  ``bigdl.elastic.step.timeout`` while the loop is live means the
  process is wedged *inside* a step — in multi-process training, almost
  always a collective whose peer died. The agent then reports
  ``status="stall"`` upstream (the heartbeat thread still runs; only the
  training thread is stuck) so the supervisor aborts the whole world,
  and arms the local abort flag so a step that *eventually* returns
  restarts instead of stepping into the next doomed collective.

Anything that legitimately keeps the loop away from ``step_heartbeat``
longer than the timeout — a first cuDNN autotune, a long validation
pass — trips exactly like a wedged collective. The cost of a false trip
is a bounded replay from the last snapshot, not a lost job; size
``step.timeout`` above it or leave it 0 (off).

The clock and the transport are injectable: unit tests drive expiry and
stall detection on a fake clock against a recorded transport, with zero
sleeping and no sockets.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Optional, Tuple

from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.elastic.snapshot import SnapshotRing

logger = logging.getLogger("bigdl_tpu_torch.elastic")


def _http_transport(address: Tuple[str, int], timeout: float = 2.0
                    ) -> Callable[[dict], dict]:
    def post(payload: dict) -> dict:
        import http.client
        conn = http.client.HTTPConnection(address[0], address[1],
                                          timeout=timeout)
        try:
            body = json.dumps(payload)
            conn.request("POST", "/elastic/heartbeat", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"supervisor answered {resp.status}: {raw[:200]!r}")
            return json.loads(raw.decode())
        finally:
            conn.close()
    return post


class ElasticAgent:
    """Heartbeat sender + collective-hang watchdog for one process."""

    def __init__(self, process_id: int,
                 ring: Optional[SnapshotRing] = None,
                 supervisor_address: Optional[Tuple[str, int]] = None,
                 transport: Optional[Callable[[dict], dict]] = None,
                 heartbeat_interval: Optional[float] = None,
                 step_timeout: Optional[float] = None,
                 generation: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        from bigdl_tpu_torch.utils.conf import conf
        self.process_id = int(process_id)
        self.ring = ring
        self.heartbeat_interval = (
            heartbeat_interval if heartbeat_interval is not None
            else conf.get_float("bigdl.elastic.heartbeat.interval", 0.5))
        self.step_timeout = (
            step_timeout if step_timeout is not None
            else conf.get_float("bigdl.elastic.step.timeout", 0.0)) or 0.0
        self.generation = (
            generation if generation is not None
            else conf.get_int("bigdl.elastic.generation", 0) or 0)
        self._clock = clock
        if transport is None and supervisor_address is not None:
            transport = _http_transport(supervisor_address)
        self._transport = transport
        self._lock = threading.Lock()
        self._abort = threading.Event()
        self._abort_reason: Optional[str] = None
        self._last_step = -1
        self._last_step_t = clock()
        self._live = False          # a step heartbeat has been seen
        self._snap_step = -1
        self._stall_reported = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0
        self.beat_failures = 0
        self.stalls = 0
        # fleet federation member surface: a training
        # process has no HTTP server of its own, so when
        # bigdl.observability.federation is on the agent runs a tiny
        # /metrics/snapshot listener and advertises its address on
        # every heartbeat — the supervisor-embedded collector polls
        # it. Off (the default): no server, no thread, no socket.
        self._metrics_server = None

    @property
    def has_supervisor(self) -> bool:
        return self._transport is not None

    # -- the optimizer-facing surface ----------------------------------------
    def step_heartbeat(self, step: int):
        """Called at the top of every optimizer iteration. Cheap: one
        clock read under the lock."""
        with self._lock:
            self._last_step = int(step)
            self._last_step_t = self._clock()
            self._live = True
            self._stall_reported = False

    def loop_idle(self):
        """The training loop left its hot section (epoch boundary
        work, loop exit): the watchdog must not count this quiet time
        as a wedged step."""
        with self._lock:
            self._live = False

    def note_snapshot(self, step: int):
        with self._lock:
            self._snap_step = max(self._snap_step, int(step))

    def should_abort(self) -> bool:
        return self._abort.is_set()

    def abort_reason(self) -> Optional[str]:
        with self._lock:
            return self._abort_reason

    def request_abort(self, reason: str):
        # the beat thread and the training loop both reach this (stall
        # report vs. directive): first reason wins, under the same lock
        # the rest of the agent state uses
        with self._lock:
            self._abort_reason = self._abort_reason or reason
        self._abort.set()

    def reset_abort(self):
        with self._lock:
            self._abort_reason = None
        self._abort.clear()

    # -- stall detection -----------------------------------------------------
    def stalled(self) -> bool:
        if self.step_timeout <= 0:
            return False
        with self._lock:
            return (self._live and
                    self._clock() - self._last_step_t > self.step_timeout)

    def check_stall(self) -> bool:
        """One watchdog tick (the heartbeat thread's, or a fake-clock
        test's). A fresh stall arms the local abort and is carried
        upstream by the next beat's ``status="stall"``."""
        if not self.stalled():
            return False
        with self._lock:
            first = not self._stall_reported
            self._stall_reported = True
        if first:
            self.stalls += 1
            age = self._clock() - self._last_step_t
            self.request_abort(
                f"step stalled: no progress past step {self._last_step} "
                f"for {age:.1f}s (> {self.step_timeout:g}s) — peer loss "
                "or wedged collective")
            from bigdl_tpu_torch import observability as obs
            if obs.enabled():
                obs.counter(
                    "bigdl_elastic_stalls_total",
                    "Wedged optimizer steps detected by the "
                    "collective-hang watchdog").inc()
            logger.warning("elastic: %s", self._abort_reason)
        return True

    # -- heartbeats ----------------------------------------------------------
    def beat(self) -> Optional[dict]:
        """One beat: stall check, then (when a supervisor is
        configured) the POST and directive handling. Raising is the
        transport's prerogative — the thread loop counts and survives
        it; tests may call this directly."""
        reliability.inject("elastic.heartbeat")
        stalled = self.check_stall()
        if self._transport is None:
            return None
        with self._lock:
            payload = {"pid": self.process_id,
                       "step": self._last_step,
                       "snap_step": self._snap_step,
                       "status": "stall" if stalled else "ok",
                       "generation": self.generation}
        if self._metrics_server is not None:
            payload["metrics_addr"] = list(self._metrics_server.address)
        out = self._transport(payload)
        self.beats += 1
        from bigdl_tpu_torch import observability as obs
        if obs.enabled():
            obs.counter("bigdl_elastic_heartbeats_total",
                        "Agent heartbeats delivered to the supervisor"
                        ).inc()
        committed = int(out.get("committed_step", -1))
        if self.ring is not None and committed >= 0:
            self.ring.commit(committed)
        if out.get("directive") == "abort":
            self.request_abort(
                "supervisor directed abort: "
                + str(out.get("reason", "world restarting")))
        return out

    def _loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self.beat()
            except Exception as e:   # noqa: BLE001 — the agent never dies
                self.beat_failures += 1
                from bigdl_tpu_torch import observability as obs
                if obs.enabled():
                    obs.counter(
                        "bigdl_elastic_heartbeat_failures_total",
                        "Heartbeats that failed to reach the supervisor"
                        ).inc()
                logger.debug("elastic heartbeat failed: %s", e)

    def start(self) -> "ElasticAgent":
        """Start the background thread — needed for the watchdog or a
        supervisor; a ring-only agent with no step timeout has nothing
        to run and stays threadless."""
        if self._thread is None and (self._transport is not None
                                     or self.step_timeout > 0):
            self._thread = threading.Thread(
                target=self._loop, name="bigdl-elastic-agent",
                daemon=True)
            self._thread.start()
        if self._metrics_server is None and self._transport is not None:
            from bigdl_tpu_torch.observability.federation import (
                SnapshotServer, federation_enabled)
            if federation_enabled():
                self._metrics_server = SnapshotServer(
                    instance=f"pid{self.process_id}").start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.heartbeat_interval + 2.0)
            self._thread = None
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
