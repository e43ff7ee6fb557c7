"""Elastic serving fleet control plane — the port of
``bigdl_tpu/llm/fleet.py``.

The router has live pool membership (``POST /backends``) and a
fleet-wide metric view (federation); this module decides membership
and lets a backend leave without abandoning its queue, its warm KV
chains or its in-flight streams, all behind ``bigdl.llm.fleet.enabled``
(default off, structurally absent):

- :class:`DrainCoordinator` — the worker-side graceful drain.
  ``POST /worker_drain`` flips the engine to DRAINING (``/healthz``
  answers 503 ``"draining"``; the router's prober stops routing new
  work there while in-flight streams keep draining), waits for every
  accepted request to finish, then migrates the warm KV chains (radix
  leaves + host-arena entries) to surviving replicas through the
  ``export_chain``/``import_chain`` handoff blobs — scale-in deletes no
  cached prefixes and loses zero requests. Cancellable at any point
  (``stop()`` during an active drain must leave no orphaned migration
  jobs and no pinned arena slots).
- :class:`FleetController` — the router-embedded autoscaler daemon. It
  reads queue depth, shed-rate deltas and pages-free signals off the
  federation snapshots (falling back to direct ``/healthz`` scrapes
  when federation is off), and drives a pluggable
  :class:`WorkerProvider` through the router's live membership:
  scale-out on sustained queue/shed pressure, drain-then-remove on
  sustained idleness, with cooldowns, min/max bounds and flap damping
  (pressure must SUSTAIN for ``bigdl.llm.fleet.sustain`` consecutive
  ticks; every action re-arms the cooldown).
- :class:`WorkerProvider` — the two-call launcher interface
  (``launch() -> (host, port)``, ``terminate(addr)``) a real deployment
  implements over its process manager.
  :class:`LocalWorkerProvider` is the in-process implementation the
  tests use: each launch builds an ``LLMServer`` over the SHARED model
  (one set of weights on the card) plus an ``LLMWorker`` surface on a
  fresh port. Unlike the JAX package, whose compiled steps are cached
  by model config, a scaled-out engine here captures its own CUDA
  graphs on its first passes. Its ``kill()`` is the fault hook: the
  HTTP surface dies abruptly, exactly like a crashed process.

Observability: ``bigdl_fleet_workers`` / ``bigdl_fleet_scale_events_
total`` / ``bigdl_fleet_drains_total`` / ``bigdl_fleet_chains_migrated_
total`` series, ``fleet/scale`` + ``worker/drain`` spans, and the
``fleet.scale`` / ``worker.drain`` fault sites. Disabled mode
constructs none of it: no controller thread, no drain coordinator, no
``bigdl_fleet_*`` series, and the ``/worker_drain`` /
``/fleet/autoscaler`` endpoints answer 404. The wire (the drain and
import bodies, the handoff blobs) is the JAX package's, so a port drain
migrates into a JAX worker and the reverse. Host code only: the
controller and the drain thread touch HTTP and host state; the engine
runs its own device work.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.observability import flight
from bigdl_tpu_torch.observability import timeseries


def fleet_enabled(override: Optional[bool] = None) -> bool:
    """The one gate every fleet surface checks
    (``bigdl.llm.fleet.enabled``, default off)."""
    if override is not None:
        return bool(override)
    from bigdl_tpu_torch.utils.conf import conf
    return conf.get_bool("bigdl.llm.fleet.enabled", False)


def _post_json(addr, path: str, body: dict, timeout: float = 10.0):
    """One JSON POST → (status, parsed body). Thin wrapper over the
    worker module's shared HTTP helper (one client implementation to
    maintain, not four). Raises on transport errors — drain/scale
    callers decide whether that is fatal."""
    from bigdl_tpu_torch.llm.worker import _post_json as post
    status, parsed, _hdrs = post(addr, path, body, timeout=timeout)
    return status, parsed


def _get_json(addr, path: str, timeout: float = 5.0):
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# graceful drain (worker side)
# ---------------------------------------------------------------------------

class DrainCoordinator:
    """Worker-side drain state machine (constructed by
    :class:`~bigdl_tpu_torch.llm.worker.LLMWorker` only when the fleet gate is
    on). States::

        idle -> draining -> migrating -> drained
                   |             |
                   +---cancel----+--> cancelled   (engine resumes)
                   |
                   +--> failed   (in-flight never finished in time)

    ``begin`` flips the engine to DRAINING (submit sheds 503
    ``"draining"``; ``/healthz`` follows) and starts one daemon thread:
    phase 1 waits for every accepted request — queued, slotted,
    fetch-parked — to finish; phase 2 exports each warm KV chain
    (:meth:`LLMServer.warm_chains`) and lands it on a surviving peer
    via ``POST /worker_import_chain``, round-robin, skipping peers that
    refuse. Chain migration is best-effort by contract: a failed export
    or a dead peer costs a re-prefill on the survivor, never a lost
    request. The ``worker.drain`` fault site fires once per chain, so a
    fault plan can kill a drain mid-migration.

    ``cancel`` stops the thread at its next checkpoint, un-drains the
    engine (unless the worker is shutting down for good), and joins —
    after it returns there are no orphaned migration posts in flight
    and no arena slots pinned by the drain (exports use the pin-less
    ``read_keyed`` copy path, so the only drain-held state is the
    thread itself)."""

    def __init__(self, server, poll_interval: float = 0.01):
        self.server = server
        self.poll_interval = poll_interval
        self._lock = threading.Lock()
        self._cancel = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.state = "idle"
        self.error: Optional[str] = None
        self.migrated_chains = 0
        self.migrated_pages = 0
        self.failed_chains = 0
        self._t0 = 0.0

    # -- lifecycle -----------------------------------------------------------
    def begin(self, peers: List[Tuple[str, int]],
              timeout: float = 60.0) -> bool:
        """Start a drain toward ``peers`` (the surviving replicas warm
        chains migrate to; empty = finish in-flight, migrate nothing).
        False if a drain is already active."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._cancel.clear()
            self.state = "draining"
            self.error = None
            self.migrated_chains = 0
            self.migrated_pages = 0
            self.failed_chains = 0
            self._t0 = time.time()
            self.server.begin_drain()
            self._thread = threading.Thread(
                target=self._run,
                args=([tuple(p) for p in peers], float(timeout)),
                name="bigdl-fleet-drain", daemon=True)
            self._thread.start()
        return True

    def cancel(self, resume: bool = True, timeout: float = 10.0):
        """Abandon a drain: stop the thread (if still running), join
        it, and — with ``resume`` — clear the engine's draining flag so
        it accepts work again. Cancelling an already-DRAINED worker
        with ``resume`` also re-opens admission (the controller
        abandoning a scale-in after the drain finished but before the
        removal). ``resume=False`` is the shutdown path — the engine is
        about to stop for good and must not briefly re-open
        admission."""
        with self._lock:
            t = self._thread
        if t is not None and t.is_alive():
            self._cancel.set()
            t.join(timeout)
        with self._lock:
            if self.state in ("draining", "migrating"):
                self.state = "cancelled"
            if resume and self.state in ("cancelled", "drained",
                                         "failed"):
                self.server.cancel_drain()
                self.state = "cancelled"

    def active(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    def status(self) -> Dict[str, Any]:
        """The ``GET /worker_drain`` body (the controller's poll)."""
        with self._lock:
            return {
                "state": self.state,
                "error": self.error,
                "migrated_chains": self.migrated_chains,
                "migrated_pages": self.migrated_pages,
                "failed_chains": self.failed_chains,
                "age_s": (round(time.time() - self._t0, 3)
                          if self._t0 else 0.0),
            }

    # -- the drain thread ----------------------------------------------------
    def _run(self, peers: List[Tuple[str, int]], timeout: float):
        t0 = time.time()
        deadline = t0 + timeout
        try:
            # phase 1: every accepted request finishes (the router keeps
            # draining the in-flight streams; submit already sheds)
            while not self._cancel.is_set():
                if self.server.engine_idle():
                    break
                if time.time() > deadline:
                    with self._lock:
                        self.state = "failed"
                        self.error = (
                            f"in-flight requests did not finish within "
                            f"{timeout:g}s")
                    return
                time.sleep(self.poll_interval)
            if self._cancel.is_set():
                with self._lock:
                    self.state = "cancelled"
                return
            # phase 2: migrate warm KV chains to the survivors
            with self._lock:
                self.state = "migrating"
            self._migrate(peers)
            if self._cancel.is_set():
                with self._lock:
                    self.state = "cancelled"
                return
            with self._lock:
                self.state = "drained"
        finally:
            wall = time.time() - t0
            if obs.enabled():
                obs.add_complete(
                    "worker/drain", t0, wall, stage="llm_worker",
                    state=self.state, chains=self.migrated_chains,
                    pages=self.migrated_pages,
                    failed=self.failed_chains)

    def _migrate(self, peers: List[Tuple[str, int]]):
        chains = self.server.warm_chains()
        if not chains or not peers:
            return
        ins = _fleet_instruments()
        rr = 0
        for chain in chains:
            if self._cancel.is_set():
                return
            try:
                # the mid-drain fault site: a raise here abandons THIS
                # chain (survivors re-prefill it) — never the drain
                reliability.inject("worker.drain")
                blob = self.server.export_chain(chain)
            except Exception as e:  # noqa: BLE001 — best-effort
                with self._lock:
                    self.failed_chains += 1
                    self.error = f"export failed: {e}"
                continue
            b64 = base64.b64encode(blob).decode()
            landed = 0
            for k in range(len(peers)):
                peer = peers[(rr + k) % len(peers)]
                try:
                    status, parsed = _post_json(
                        peer, "/worker_import_chain", {"handoff": b64})
                except Exception:   # noqa: BLE001 — dead peer: next
                    continue
                if status == 200:
                    landed = int(parsed.get("imported_pages", 0))
                    rr = (rr + k + 1) % len(peers)
                    break
            if landed:
                with self._lock:
                    self.migrated_chains += 1
                    self.migrated_pages += landed
                flight.record("drain_migrate", pages=landed,
                              peer=f"{peer[0]}:{peer[1]}")
                if ins is not None:
                    ins["chains"].inc()
            else:
                with self._lock:
                    self.failed_chains += 1


# ---------------------------------------------------------------------------
# worker providers
# ---------------------------------------------------------------------------

class WorkerProvider:
    """What the autoscaler drives — the entire launcher contract:

    - ``launch() -> (host, port)``: bring up one decode-role worker
      (fleet-enabled, same model/config as the pool) and return its
      address once it serves ``/healthz``. Raise on failure — the
      controller counts it and backs off.
    - ``terminate(addr)``: tear one down for good (it has already been
      drained and removed from the router pool). Must tolerate unknown
      addresses (a worker the provider never launched, or one that
      crashed meanwhile).

    Real deployments implement these two calls over their process
    manager (subprocess + ``python -m``, k8s Deployments, cloud
    instance groups). The in-process :class:`LocalWorkerProvider` below
    is the tests' implementation."""

    def launch(self) -> Tuple[str, int]:
        raise NotImplementedError

    def terminate(self, addr) -> None:
        raise NotImplementedError


class LocalWorkerProvider(WorkerProvider):
    """In-process provider for tests: each ``launch`` builds an
    ``LLMServer`` over the SHARED model object (one set of weights; the
    new engine captures its own graphs) plus a decode-role,
    fleet-enabled ``LLMWorker`` on a fresh port. ``server_kwargs`` must
    carry ``device="cpu"`` off the card. ``kill`` is the fault hook —
    the HTTP surface and engine die without a drain, exactly like a
    crashed process."""

    def __init__(self, model, server_kwargs: Optional[dict] = None,
                 worker_kwargs: Optional[dict] = None):
        self.model = model
        self.server_kwargs = dict(server_kwargs or {})
        self.worker_kwargs = dict(worker_kwargs or {})
        self._lock = threading.Lock()
        self._pairs: Dict[Tuple[str, int], tuple] = {}
        self.launches = 0
        self.terminations = 0

    def launch(self) -> Tuple[str, int]:
        from bigdl_tpu_torch.llm.serving import LLMServer
        from bigdl_tpu_torch.llm.worker import LLMWorker
        srv = LLMServer(self.model, **self.server_kwargs).start()
        try:
            w = LLMWorker(srv, role="decode", fleet=True,
                          **self.worker_kwargs).start()
        except BaseException:
            srv.stop(drain=False)
            raise
        addr = tuple(w.address)
        with self._lock:
            self._pairs[addr] = (srv, w)
            self.launches += 1
        return addr

    def servers(self) -> Dict[Tuple[str, int], Any]:
        """Live ``{addr: LLMServer}`` — a window into engine state
        (prefix hits, ledger idleness)."""
        with self._lock:
            return {a: p[0] for a, p in self._pairs.items()}

    def terminate(self, addr) -> None:
        with self._lock:
            pair = self._pairs.pop(tuple(addr), None)
            if pair is not None:
                self.terminations += 1
        if pair is not None:
            srv, w = pair
            w.stop()
            srv.stop()

    def kill(self, addr) -> None:
        """Abrupt death: no drain, no graceful engine stop."""
        with self._lock:
            pair = self._pairs.pop(tuple(addr), None)
        if pair is not None:
            srv, w = pair
            w.stop()
            srv.stop(drain=False)

    def stop_all(self):
        with self._lock:
            pairs = list(self._pairs.values())
            self._pairs.clear()
        for srv, w in pairs:
            w.stop()
            srv.stop(drain=False)


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------

def _fleet_instruments() -> Optional[Dict[str, Any]]:
    """The ``bigdl_fleet_*`` series — declared only when observability
    records AND a fleet object is calling (this module is only imported
    behind the gate, so disabled mode mints nothing)."""
    if not obs.enabled():
        return None
    return {
        "workers": obs.gauge(
            "bigdl_fleet_workers",
            "Decode-pool size the autoscaler currently maintains"),
        "scale_events": obs.counter(
            "bigdl_fleet_scale_events_total",
            "Autoscaler pool changes by direction",
            labelnames=("direction",)),
        "drains": obs.counter(
            "bigdl_fleet_drains_total",
            "Graceful worker drains by outcome",
            labelnames=("outcome",)),
        "chains": obs.counter(
            "bigdl_fleet_chains_migrated_total",
            "Warm KV chains migrated to survivors during drains"),
    }


class FleetController:
    """Router-embedded autoscaler (constructed by
    :class:`~bigdl_tpu_torch.llm.worker.LLMRouter` only when the fleet gate is
    on; requires failover mode for the prober + live ``POST /backends``
    membership).

    One ``tick`` per ``bigdl.llm.fleet.interval`` seconds:

    1. read :meth:`signals` — per-worker queue depth and active slots,
       the cumulative shed counter, and the worst pool occupancy,
       preferring the federation snapshots (``bigdl_llm_queue_
       depth`` / ``bigdl_llm_active_slots`` / ``bigdl_llm_kv_pool_
       occupancy`` / ``bigdl_reliability_shed_total`` per instance)
       and falling back to direct ``/healthz`` scrapes when federation
       is off or a member has no snapshot yet;
    2. classify: **pressure** when total queue depth exceeds
       ``queue.high`` × workers, sheds grew since the last tick, or
       every worker's page pool is above 90% occupancy; **idle** when
       queue + active work sits at or below ``idle.low`` (absolute);
    3. act only on SUSTAINED signals (``sustain`` consecutive ticks —
       the flap damper) outside the ``cooldown`` window and inside the
       ``[min, max]`` bounds: scale-out = ``provider.launch()`` + pool
       add; scale-in = pick the newest backend, mark it draining at the
       prober (no new dispatch from the next ``_pick`` on), ``POST
       /worker_drain`` with the survivors as migration peers, poll
       until drained, then pool-remove + ``provider.terminate``. A
       drain that fails or times out is cancelled (the worker resumes);
       a worker that DIES mid-drain is removed anyway — its in-flight
       streams already failed over, its chains re-prefill.

    Every scale action runs under the ``fleet.scale`` fault site and a
    ``fleet/scale`` span. With no provider the controller still drains
    and removes (scale-in works on externally-launched workers) but
    counts scale-out decisions as ``no_provider`` events instead of
    acting."""

    THREAD_NAME = "bigdl-fleet-controller"

    def __init__(self, router, provider: Optional[WorkerProvider] = None,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 interval: Optional[float] = None,
                 cooldown: Optional[float] = None,
                 sustain: Optional[int] = None,
                 queue_high: Optional[float] = None,
                 idle_low: Optional[float] = None,
                 drain_timeout: Optional[float] = None):
        from bigdl_tpu_torch.utils.conf import conf
        self.router = router
        self.provider = provider
        self.min_workers = max(1, int(
            min_workers if min_workers is not None
            else conf.get_int("bigdl.llm.fleet.min", 1)))
        self.max_workers = max(self.min_workers, int(
            max_workers if max_workers is not None
            else conf.get_int("bigdl.llm.fleet.max", 4)))
        self.interval = float(
            interval if interval is not None
            else conf.get_float("bigdl.llm.fleet.interval", 1.0))
        self.cooldown = float(
            cooldown if cooldown is not None
            else conf.get_float("bigdl.llm.fleet.cooldown", 5.0))
        self.sustain = max(1, int(
            sustain if sustain is not None
            else conf.get_int("bigdl.llm.fleet.sustain", 2)))
        self.queue_high = float(
            queue_high if queue_high is not None
            else conf.get_float("bigdl.llm.fleet.queue.high", 2.0))
        self.idle_low = float(
            idle_low if idle_low is not None
            else conf.get_float("bigdl.llm.fleet.idle.low", 0.0))
        self.drain_timeout = float(
            drain_timeout if drain_timeout is not None
            else conf.get_float("bigdl.llm.fleet.drain.timeout", 30.0))
        # class-split pressure: an interactive backlog above
        # queue_high on ANY single worker's share is pressure even when
        # the fleet-wide total looks fine — batch depth must not hide
        # interactive starvation. Inert unless workers report class
        # depths (bigdl.llm.priority.enabled on the engines).
        self.pressure_interactive = conf.get_bool(
            "bigdl.llm.fleet.pressure.interactive", True)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._hot = 0                 # consecutive pressured ticks
        self._cold = 0                # consecutive idle ticks
        self._last_action = 0.0       # monotonic stamp of the last act
        # per-member reset-aware shed deltas through the window
        # primitive: a restarted member's counter drop is a reset for
        # that member only, never a clamp that swallows the others'
        # sheds
        self._sheds = timeseries.WindowedCounter()
        self.decisions: List[dict] = []   # bounded per-tick trace
        self._draining: Optional[dict] = None   # {"addr", "t0"}
        self.scale_outs = 0
        self.scale_ins = 0
        self.drains_lost = 0          # workers that died mid-drain
        self.ticks = 0
        self.events: List[dict] = []  # bounded action log
        self._ins: Optional[Dict[str, Any]] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetController":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=self.THREAD_NAME, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        """Stop the control loop; an in-progress drain is CANCELLED
        (router shutdown mid-drain must not orphan the worker in a
        draining state it would never leave)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5.0)
            self._thread = None
        with self._lock:
            dr = self._draining
            self._draining = None
        if dr is not None:
            try:
                _post_json(dr["addr"], "/worker_drain",
                           {"action": "cancel"}, timeout=5.0)
                self._record_drain("cancelled")
            except Exception:   # noqa: BLE001 — it may already be dead
                pass

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 — the controller never dies
                pass

    # -- signals -------------------------------------------------------------
    def _pool(self) -> List[Tuple[str, int]]:
        with self.router._pool_lock:
            return list(self.router.decode_workers)

    def signals(self) -> Dict[str, Any]:
        """The autoscaler's inputs this tick. Federation snapshots are
        the primary source; members without one (federation off, first
        sweep pending) are filled in from a direct ``/healthz``
        scrape."""
        pool = self._pool()
        per: Dict[str, dict] = {}
        source = "healthz"
        collector = getattr(self.router, "_collector", None)
        if collector is not None:
            source = "federation"
            for inst, snap in collector.snapshots().items():
                if snap is None or inst == "router":
                    continue
                per[inst] = self._from_snapshot(snap)
        queue = active = 0.0
        sheds = 0.0
        sheds_by: Dict[str, float] = {}
        occ_max = 0.0
        q_interactive = 0.0
        parked_by: Dict[Tuple[str, int], float] = {}
        for addr in pool:
            name = f"{addr[0]}:{addr[1]}"
            vals = per.get(name)
            if vals is None:
                vals = self._from_healthz(addr)
            queue += vals.get("queue", 0.0)
            active += vals.get("active", 0.0)
            sheds += vals.get("sheds", 0.0)
            if "sheds" in vals:
                sheds_by[name] = float(vals["sheds"])
            occ_max = max(occ_max, vals.get("occupancy", 0.0))
            q_interactive += vals.get("queue_interactive", 0.0)
            parked_by[tuple(addr)] = vals.get("parked", 0.0)
        journal = getattr(self.router, "_journal", None)
        return {
            "workers": len(pool),
            "queue": queue,
            "active": active,
            "inflight": journal.inflight() if journal else 0,
            "sheds": sheds,
            # per-member cumulative sheds: the WindowedCounter's keys,
            # so each member's counter resets independently
            "sheds_by": sheds_by,
            "occupancy_max": occ_max,
            # zero everywhere unless engines run the
            # priority scheduler — the class-pressure term and the
            # scale-in parked filter are then inert
            "queue_interactive": q_interactive,
            "parked_by": parked_by,
            "source": source,
        }

    @staticmethod
    def _from_snapshot(snap: dict) -> dict:
        out = {"queue": 0.0, "active": 0.0, "sheds": 0.0,
               "occupancy": 0.0}
        for m in snap.get("metrics", []):
            name = m.get("name")
            if name == "bigdl_llm_queue_depth":
                for s in m.get("series", []):
                    out["queue"] += float(s.get("value", 0.0))
            elif name == "bigdl_llm_active_slots":
                for s in m.get("series", []):
                    out["active"] += float(s.get("value", 0.0))
            elif name == "bigdl_reliability_shed_total":
                for s in m.get("series", []):
                    out["sheds"] += float(s.get("value", 0.0))
            elif name == "bigdl_llm_kv_pool_occupancy":
                for s in m.get("series", []):
                    out["occupancy"] = max(out["occupancy"],
                                           float(s.get("value", 0.0)))
            elif name == "bigdl_llm_queue_depth_class":
                # series labels are the label-value tuple in
                # labelnames order — ("class",) here
                for s in m.get("series", []):
                    if list(s.get("labels", [])) == ["interactive"]:
                        out["queue_interactive"] = \
                            out.get("queue_interactive", 0.0) \
                            + float(s.get("value", 0.0))
            elif name == "bigdl_llm_preempt_parked":
                for s in m.get("series", []):
                    out["parked"] = out.get("parked", 0.0) \
                        + float(s.get("value", 0.0))
        return out

    @staticmethod
    def _from_healthz(addr) -> dict:
        try:
            _status, body = _get_json(addr, "/healthz", timeout=2.0)
        except Exception:   # noqa: BLE001 — dead member contributes 0
            return {}
        out = {"queue": float(body.get("queue_length", 0) or 0)}
        by_class = body.get("queue_by_class")
        if isinstance(by_class, dict):
            out["queue_interactive"] = \
                float(by_class.get("interactive", 0) or 0)
        if "preempt_parked" in body:
            out["parked"] = float(body.get("preempt_parked", 0) or 0)
        return out

    # -- the control loop ----------------------------------------------------
    def tick(self):
        """One control decision (also the tests' fake clock — no
        sleeping)."""
        self.ticks += 1
        if self._draining is not None:
            self._poll_drain()
            self._record_gauges()
            return
        sig = self.signals()
        n = sig["workers"]
        # a signals() override that predates the per-member contract
        # (or a healthz-only scrape) may carry just the aggregate —
        # feed it as a single-key observation so delta math still runs
        sheds_by = sig.get("sheds_by")
        if not sheds_by and "sheds" in sig:
            sheds_by = {"__total__": float(sig["sheds"])}
        shed_delta = self._sheds.observe(sheds_by or {})
        pressure = (sig["queue"] > self.queue_high * max(n, 1)
                    or shed_delta > 0
                    or (n > 0 and sig["occupancy_max"] > 0.9)
                    or (self.pressure_interactive
                        and sig.get("queue_interactive", 0.0)
                        > self.queue_high))
        load = sig["queue"] + sig["active"] + sig["inflight"]
        idle = load <= self.idle_low
        if pressure:
            self._hot += 1
            self._cold = 0
        elif idle:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = 0
            self._cold = 0
        now = time.monotonic()
        cool = now - self._last_action < self.cooldown \
            and self._last_action > 0
        action = "none"
        if pressure and self._hot >= self.sustain and not cool \
                and n < self.max_workers:
            action = "scale_out"
            self._scale_out(sig)
        elif idle and self._cold >= self.sustain and not cool \
                and n > self.min_workers:
            action = "scale_in"
            self._begin_scale_in(sig)
        # bounded decision trace: the per-tick inputs and verdicts, so
        # a run can replay the pressure/idle/action sequence
        self.decisions.append({
            "tick": self.ticks, "workers": n, "queue": sig["queue"],
            "sheds_by": dict(sig.get("sheds_by") or {}),
            "shed_delta": shed_delta, "pressure": pressure,
            "idle": idle, "action": action})
        if len(self.decisions) > 512:
            del self.decisions[:-512]
        self._record_gauges()

    def _scale_out(self, sig: dict):
        self._hot = 0
        self._last_action = time.monotonic()
        if self.provider is None:
            self._event("no_provider", None, sig)
            return
        t0 = time.time()
        try:
            reliability.inject("fleet.scale")
            addr = tuple(self.provider.launch())
            self.router._admin_backends(
                {"action": "add", "role": "decode",
                 "host": addr[0], "port": addr[1]})
        except Exception as e:  # noqa: BLE001 — count, back off
            self._event("scale_out_failed", None, sig, error=str(e))
            return
        self.scale_outs += 1
        self._event("scale_out", addr, sig)
        ins = self._instruments()
        if ins is not None:
            ins["scale_events"].labels(direction="out").inc()
        if obs.enabled():
            obs.add_complete(
                "fleet/scale", t0, time.time() - t0, stage="llm_router",
                direction="out", backend=f"{addr[0]}:{addr[1]}",
                workers=sig["workers"] + 1)

    def _begin_scale_in(self, sig: dict):
        self._cold = 0
        self._last_action = time.monotonic()
        pool = self._pool()
        if len(pool) <= self.min_workers:
            return
        # newest first: LIFO scale-in — but never the worker holding
        # preempted-parked chains: draining it
        # would force every parked request through a full re-prefill
        # on a peer, exactly the latency the preemption tried to save
        parked_by = sig.get("parked_by", {})
        victim = None
        for cand in reversed(pool):
            if parked_by.get(tuple(cand), 0.0) <= 0:
                victim = cand
                break
        if victim is None:
            victim = pool[-1]        # every worker holds parked chains:
            # fall back to plain LIFO rather than wedging scale-in
        peers = [list(a) for a in pool if a != victim]
        try:
            reliability.inject("fleet.scale")
            # stop new dispatch IMMEDIATELY (the prober would take one
            # sweep to observe the draining healthz)
            prober = getattr(self.router, "_prober", None)
            if prober is not None:
                prober.mark(victim, "draining")
            status, body = _post_json(
                victim, "/worker_drain",
                {"action": "begin", "peers": peers,
                 "timeout": self.drain_timeout})
            if status != 200:
                raise RuntimeError(
                    f"worker_drain answered {status}: "
                    f"{body.get('error', '')}")
        except Exception as e:  # noqa: BLE001
            self._event("scale_in_failed", victim, sig, error=str(e))
            self._unmark(victim)
            return
        with self._lock:
            self._draining = {"addr": victim, "t0": time.monotonic(),
                              "span_t0": time.time()}
        self._event("drain_begun", victim, sig)

    def _poll_drain(self):
        dr = self._draining
        victim = dr["addr"]
        try:
            _status, body = _get_json(victim, "/worker_drain")
            state = body.get("state", "")
        except Exception:   # noqa: BLE001 — the victim died mid-drain
            # its in-flight streams already failed over (journal), its
            # chains re-prefill on survivors: remove the corpse
            self._finish_scale_in(victim, outcome="lost",
                                  body={"state": "dead"})
            self.drains_lost += 1
            return
        if state == "drained":
            self._finish_scale_in(victim, outcome="drained", body=body)
        elif state in ("failed", "cancelled") or \
                time.monotonic() - dr["t0"] > self.drain_timeout + \
                2 * max(self.interval, 0.05):
            # abandon the scale-in: cancel (resumes admission) and put
            # the worker back into rotation
            try:
                _post_json(victim, "/worker_drain", {"action": "cancel"})
            except Exception:   # noqa: BLE001
                pass
            self._unmark(victim)
            with self._lock:
                self._draining = None
            self._last_action = time.monotonic()
            self._event("drain_abandoned", victim, {})
            self._record_drain("cancelled")

    def _finish_scale_in(self, victim, outcome: str, body: dict):
        with self._lock:
            dr = self._draining
            self._draining = None
        try:
            self.router._admin_backends(
                {"action": "remove", "role": "decode",
                 "host": victim[0], "port": victim[1]})
        except Exception as e:  # noqa: BLE001 — last-backend guard
            self._unmark(victim)
            self._event("scale_in_failed", victim, {}, error=str(e))
            return
        if self.provider is not None:
            try:
                self.provider.terminate(victim)
            except Exception:   # noqa: BLE001 — already dead is fine
                pass
        self.scale_ins += 1
        self._last_action = time.monotonic()
        self._event("scale_in", victim, {}, outcome=outcome,
                    chains=body.get("migrated_chains", 0))
        self._record_drain(outcome)
        ins = self._instruments()
        if ins is not None:
            ins["scale_events"].labels(direction="in").inc()
        if obs.enabled():
            t0 = dr.get("span_t0", time.time())
            obs.add_complete(
                "fleet/scale", t0, time.time() - t0, stage="llm_router",
                direction="in", backend=f"{victim[0]}:{victim[1]}",
                outcome=outcome,
                chains_migrated=body.get("migrated_chains", 0))

    def _unmark(self, addr):
        prober = getattr(self.router, "_prober", None)
        if prober is not None:
            prober.mark(addr, "ok")

    # -- accounting ----------------------------------------------------------
    def _event(self, action: str, addr, sig: dict, **extra):
        ev = {"ts": round(time.time(), 3), "action": action,
              "backend": f"{addr[0]}:{addr[1]}" if addr else None}
        if sig:
            ev["signals"] = {k: sig[k] for k in
                             ("workers", "queue", "active", "sheds")
                             if k in sig}
        ev.update(extra)
        with self._lock:
            self.events.append(ev)
            del self.events[:-64]
        if action in ("scale_out", "scale_in"):
            flight.record(action, backend=ev["backend"],
                          **{k: v for k, v in ev.items()
                               if k in ("signals", "outcome", "chains")})

    def _instruments(self):
        if not obs.enabled():
            return None
        if self._ins is None:
            self._ins = _fleet_instruments()
        return self._ins

    def _record_gauges(self):
        ins = self._instruments()
        if ins is not None:
            ins["workers"].set(len(self._pool()))

    def _record_drain(self, outcome: str):
        ins = self._instruments()
        if ins is not None:
            ins["drains"].labels(outcome=outcome).inc()

    def status(self) -> Dict[str, Any]:
        """The ``GET /fleet/autoscaler`` body."""
        with self._lock:
            events = list(self.events[-16:])
        dr = self._draining
        return {
            "min": self.min_workers, "max": self.max_workers,
            "workers": len(self._pool()),
            "interval_s": self.interval,
            "cooldown_s": self.cooldown,
            "sustain": self.sustain,
            "queue_high": self.queue_high,
            "idle_low": self.idle_low,
            "ticks": self.ticks,
            "scale_outs": self.scale_outs,
            "scale_ins": self.scale_ins,
            "drains_lost": self.drains_lost,
            "draining": (f"{dr['addr'][0]}:{dr['addr'][1]}"
                         if dr else None),
            "provider": (type(self.provider).__name__
                         if self.provider is not None else None),
            "events": events,
        }
