"""Training-job supervisor — the port of
``bigdl_tpu/elastic/supervisor.py``, plain Python.

The coordinator side of elastic multi-process training: a small HTTP
surface (the same ``http.server`` idiom as the serving workers) that
every :class:`~bigdl_tpu_torch.elastic.agent.ElasticAgent` posts
heartbeats to. The supervisor tracks per-process liveness, step
progress and snapshot progress, and runs the world state machine:

::

    RUNNING --(peer heartbeat expired | peer reported stall |
               peer exited nonzero)--> RESTARTING
    RESTARTING --(launcher killed survivors, bumped the generation,
                  respawned the worker set)--> RUNNING (gen+1)

Detection is bounded in time: a dead peer stops heartbeating (expiry
after ``bigdl.elastic.heartbeat.timeout``), a wedged peer's own
collective-hang watchdog reports ``status="stall"`` on its still-running
heartbeat thread, and a crashed peer's exit code is seen by the
launcher. While RESTARTING, every heartbeat is answered with
``directive="abort"`` so survivors stop stepping into a collective
their peers will never join.

Commit tracking: each beat carries the sender's newest RAM-snapshot
step; once every expected peer has reported, the committed step is the
minimum across the live world, and it rides back on every heartbeat
response for the agents' :meth:`SnapshotRing.commit`. The gauges go to
the port's ``observability`` registry under the JAX package's series
names (``bigdl_elastic_world_size``, ``_generation``, ``_step_skew``,
``_committed_step``).

The clock is injectable (``clock=``) so the state machine unit-tests run
on a fake clock with zero sleeping; ``sweep()`` is the explicit expiry
scan the launcher polls (heartbeats also sweep inline).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("bigdl_tpu_torch.elastic")

#: World states.
RUNNING, RESTARTING = "running", "restarting"


class _Peer:
    __slots__ = ("pid", "last_seen", "step", "snap_step", "status",
                 "beats", "metrics_addr")

    def __init__(self, pid: int, now: float):
        self.pid = pid
        self.last_seen = now
        self.step = 0
        self.snap_step = -1
        self.status = "ok"
        self.beats = 0
        # federation: the peer's /metrics/snapshot listener,
        # advertised on its heartbeats when the plane is enabled
        self.metrics_addr = None


class Supervisor:
    """Membership + heartbeat + commit tracker for one training job.

    Pure-python core (:meth:`heartbeat`, :meth:`sweep`,
    :meth:`begin_generation`, :meth:`status`) with an optional HTTP
    wrapper (:meth:`start` / :meth:`stop`) serving::

        POST /elastic/heartbeat   {pid, step, snap_step, status, generation}
          -> {directive, generation, committed_step, reason?}
        GET  /elastic/status      full world view (debug surface)
        GET  /healthz             200 while RUNNING, 503 while RESTARTING
    """

    def __init__(self, expected: int,
                 heartbeat_timeout: Optional[float] = None,
                 join_timeout: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 host: str = "127.0.0.1", port: int = 0):
        from bigdl_tpu_torch.utils.conf import conf
        self.expected = int(expected)
        self.heartbeat_timeout = (
            heartbeat_timeout if heartbeat_timeout is not None
            else conf.get_float("bigdl.elastic.heartbeat.timeout", 5.0))
        self.join_timeout = (
            join_timeout if join_timeout is not None
            else conf.get_float("bigdl.elastic.join.timeout", 300.0)) or 0.0
        self._clock = clock
        self._lock = threading.Lock()
        self._peers: Dict[int, _Peer] = {}
        self._departed: set = set()    # clean exits this generation
        self._gen_started = clock()
        self.generation = 0
        self.state = RUNNING
        self._committed = -1
        #: chronological failure log: (generation, reason) tuples
        self.failures: List[tuple] = []
        self.stalls = 0
        self.expiries = 0
        self._host, self._port = host, port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        # fleet federation: supervisor-embedded collector
        # over the live peers' advertised /metrics/snapshot listeners.
        # Constructed ONLY when bigdl.observability.federation is on —
        # disabled means no collector thread and the fleet endpoints
        # stay 404 like any unknown path.
        self._collector = None
        from bigdl_tpu_torch.observability.federation import federation_enabled
        if federation_enabled():
            from bigdl_tpu_torch.observability.federation import (
                FederationCollector)
            self._collector = FederationCollector(
                self._federation_targets, include_self="supervisor")

    def _federation_targets(self):
        with self._lock:
            return [(f"pid{p.pid}", tuple(p.metrics_addr))
                    for p in self._peers.values()
                    if p.metrics_addr is not None]

    # -- core state machine --------------------------------------------------
    def heartbeat(self, pid: int, step: int = 0, snap_step: int = -1,
                  status: str = "ok", generation: int = 0,
                  metrics_addr=None) -> dict:
        """Process one beat; returns the directive the agent acts on."""
        if metrics_addr is not None:
            # validate BEFORE any peer state mutates, so a malformed
            # beat is a clean 422, not a half-recorded beat + traceback
            try:
                metrics_addr = (str(metrics_addr[0]),
                                int(metrics_addr[1]))
            except (IndexError, TypeError, ValueError):
                raise ValueError(
                    f"bad metrics_addr {metrics_addr!r}") from None
        now = self._clock()
        with self._lock:
            if generation != self.generation:
                # a ghost from a previous (or somehow future) worker set:
                # never let it rejoin the membership table — tell it to
                # abort so a not-yet-killed old worker stops stepping
                return {"directive": "abort",
                        "generation": self.generation,
                        "committed_step": self._committed,
                        "reason": f"stale generation {generation} "
                                  f"(current {self.generation})"}
            peer = self._peers.get(pid)
            if peer is None:
                peer = self._peers[pid] = _Peer(pid, now)
                logger.info("elastic: process %d joined generation %d "
                            "(%d/%d)", pid, self.generation,
                            len(self._peers), self.expected)
            peer.last_seen = now
            peer.step = int(step)
            peer.snap_step = max(peer.snap_step, int(snap_step))
            peer.status = status
            peer.beats += 1
            if metrics_addr is not None:
                peer.metrics_addr = metrics_addr
            if status == "stall":
                self.stalls += 1
                self._fail_locked(f"process {pid} reported a stalled "
                                  f"step (step={step})")
            self._sweep_locked(now)
            self._update_committed_locked()
            out = {"directive": ("ok" if self.state == RUNNING
                                 else "abort"),
                   "generation": self.generation,
                   "committed_step": self._committed}
            if self.state != RUNNING and self.failures:
                out["reason"] = self.failures[-1][1]
        self._export_gauges()
        return out

    def sweep(self) -> bool:
        """Expire silent peers; returns True while the world is
        healthy. The launcher polls this; beats call it inline."""
        with self._lock:
            self._sweep_locked(self._clock())
            ok = self.state == RUNNING
        self._export_gauges()
        return ok

    def _sweep_locked(self, now: float):
        if self.state != RUNNING:
            return
        for peer in self._peers.values():
            if now - peer.last_seen > self.heartbeat_timeout:
                self.expiries += 1
                self._fail_locked(
                    f"process {peer.pid} heartbeat expired "
                    f"({now - peer.last_seen:.1f}s > "
                    f"{self.heartbeat_timeout:g}s)")
                return
        # join deadline: a worker wedged BEFORE its first heartbeat
        # (stuck distributed init, a hung first collective) never
        # registers, so peer expiry can't see it — without this the
        # job hangs unboundedly, the exact failure elastic exists to
        # bound
        if self.join_timeout > 0 and \
                len(self._peers) + len(self._departed) < self.expected \
                and now - self._gen_started > self.join_timeout:
            self._fail_locked(
                f"only {len(self._peers)}/{self.expected} processes "
                f"joined generation {self.generation} within the "
                f"{self.join_timeout:g}s join timeout")

    def _fail_locked(self, reason: str):
        if self.state == RESTARTING:
            return
        self.state = RESTARTING
        self.failures.append((self.generation, reason))
        logger.warning("elastic: world failed in generation %d: %s",
                       self.generation, reason)

    def fail(self, reason: str):
        """External failure report (the launcher saw a nonzero exit)."""
        with self._lock:
            self._fail_locked(reason)
        self._export_gauges()

    def leave(self, pid: int):
        """Graceful departure (the launcher saw exit code 0): a
        finished worker must stop being a liveness obligation, or its
        inevitable heartbeat expiry would restart a perfectly healthy
        world while slower peers finish up."""
        with self._lock:
            if self._peers.pop(pid, None) is not None:
                logger.info("elastic: process %d left cleanly", pid)
            self._departed.add(pid)
            # the floor keeps moving for the remaining live peers
            self._update_committed_locked()
        self._export_gauges()

    def _update_committed_locked(self):
        # everyone still obligated must have reported: the expected
        # world minus clean departures (a finished peer's snapshots
        # are no longer a constraint — the floor keeps advancing for
        # the survivors instead of freezing for the rest of the job)
        if not self._peers or \
                len(self._peers) + len(self._departed) < self.expected:
            return
        floor = min(p.snap_step for p in self._peers.values())
        if floor > self._committed:
            self._committed = floor

    def begin_generation(self) -> int:
        """Reset membership for a fresh worker set (the launcher calls
        this after killing the survivors, before respawning). The
        committed step survives: it names the snapshot the new set
        resumes from."""
        with self._lock:
            self.generation += 1
            self._peers.clear()
            self._departed.clear()
            self._gen_started = self._clock()
            self.state = RUNNING
            gen = self.generation
        self._export_gauges()
        return gen

    # -- views ---------------------------------------------------------------
    @property
    def committed_step(self) -> int:
        with self._lock:
            return self._committed

    def live_peers(self) -> int:
        with self._lock:
            return len(self._peers)

    def step_skew(self) -> int:
        """Max-minus-min step across the registered world: the
        straggler gauge (0 when fewer than two peers)."""
        with self._lock:
            steps = [p.step for p in self._peers.values()]
        return max(steps) - min(steps) if len(steps) > 1 else 0

    def status(self) -> dict:
        with self._lock:
            now = self._clock()
            return {
                "state": self.state,
                "generation": self.generation,
                "expected": self.expected,
                "committed_step": self._committed,
                "peers": {str(p.pid): {
                    "age_s": round(now - p.last_seen, 3),
                    "step": p.step, "snap_step": p.snap_step,
                    "status": p.status, "beats": p.beats}
                    for p in self._peers.values()},
                "failures": [{"generation": g, "reason": r}
                             for g, r in self.failures],
            }

    def _export_gauges(self):
        from bigdl_tpu_torch import observability as obs
        if not obs.enabled():
            return
        obs.gauge("bigdl_elastic_world_size",
                  "Live (heartbeating) training processes this "
                  "generation").set(self.live_peers())
        obs.gauge("bigdl_elastic_generation",
                  "Worker-set generation (restarts of the world)"
                  ).set(self.generation)
        obs.gauge("bigdl_elastic_step_skew",
                  "Max-min optimizer step across live peers "
                  "(straggler gauge)").set(self.step_skew())
        obs.gauge("bigdl_elastic_committed_step",
                  "Newest snapshot step every live peer has taken"
                  ).set(self.committed_step)

    # -- HTTP surface --------------------------------------------------------
    def start(self) -> "Supervisor":
        sup = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):   # quiet: beats are chatty
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # time-series plane: windowed queries,
                # fleet timelines and the alert table over the
                # supervisor's collector cache; 404 arms included
                from bigdl_tpu_torch.observability import (alerts as _alerts,
                                                     timeseries as _ts)
                debug = _ts.debug_endpoint(self.path)
                if debug is None:
                    debug = _alerts.debug_endpoint(self.path)
                if debug is not None:
                    self._json(*debug)
                elif self.path == "/elastic/status":
                    self._json(200, sup.status())
                elif self.path == "/healthz":
                    ok = sup.sweep()
                    self._json(200 if ok else 503,
                               {"ok": ok, "state": sup.state,
                                "generation": sup.generation})
                elif self.path == "/metrics" and \
                        sup._collector is not None:
                    # fleet view of the training job:
                    # merged peer snapshots + the supervisor's own
                    # registry. Structurally absent (404) when the
                    # federation plane is off.
                    from bigdl_tpu_torch import observability as obs
                    body = sup._collector.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", obs.CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/fleet/status" and \
                        sup._collector is not None:
                    self._json(200, sup._collector.status())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/elastic/heartbeat":
                    self._json(404, {"error": "unknown path"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    out = sup.heartbeat(
                        pid=int(req["pid"]),
                        step=int(req.get("step", 0)),
                        snap_step=int(req.get("snap_step", -1)),
                        status=str(req.get("status", "ok")),
                        generation=int(req.get("generation", 0)),
                        metrics_addr=req.get("metrics_addr"))
                except (KeyError, TypeError, ValueError) as e:
                    self._json(422, {"error": f"bad heartbeat: {e}"})
                    return
                self._json(200, out)

        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="bigdl-elastic-supervisor", daemon=True)
        self._thread.start()
        if self._collector is not None:
            self._collector.start()
        from bigdl_tpu_torch.observability import timeseries
        self._timeseries = timeseries.acquire()
        if self._timeseries is not None and self._collector is not None:
            timeseries.attach_collector(self._collector)
        return self

    @property
    def address(self):
        if self._httpd is None:
            return None
        return self._httpd.server_address[:2]

    def stop(self):
        if getattr(self, "_timeseries", None) is not None:
            from bigdl_tpu_torch.observability import timeseries
            if self._collector is not None:
                timeseries.detach_collector(self._collector)
            timeseries.release()
            self._timeseries = None
        if self._collector is not None:
            self._collector.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
