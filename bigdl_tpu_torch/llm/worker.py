"""FastChat-style model worker over the port's :class:`LLMServer` — the
port of ``bigdl_tpu/llm/worker.py``'s ``LLMWorker`` (stdlib HTTP only).

Endpoints (bodies, status codes and headers are the JAX worker's):

- ``POST /worker_generate``        {"prompt_ids": [...], "max_new_tokens"?}
  → blocks → {"output_ids": [...], "finish_reason": "stop"|"length"}
- ``POST /worker_generate_stream`` same body → chunked JSON lines, one
  per newly drained token group: {"output_ids": [...so far], "done":
  bool}; the terminal chunk carries ``finish_reason``, or the engine's
  ``error`` with ``retriable: true``
- ``GET  /worker_get_status``      {"model", "role", "queue_length",
  "steps", "speed"} (+ the class backlog with priority classes)
- ``GET  /healthz``                200/503: engine-thread liveness, the
  reliability health checks, draining, and with ``watchdog_timeout``
  the watchdog block (a stalled engine answers 503 ``"stalled"``); the
  SLO block with ``slo=True``
- ``GET  /metrics``                Prometheus text of the port's registry
- ``GET  /debug/trace/<id>``, ``/debug/traces``, ``/debug/flight``,
  ``/debug/explain/<id>``, ``/debug/kvcache`` (404 when their plane is
  off)
- the prefill / decode roles (``role=``, ``bigdl.llm.role``):
  ``POST /worker_prefill`` runs a prompt for one token and exports its
  KV chain as a base64 handoff blob; ``POST /worker_import_chain`` lands
  one in the host arena (``LLMServer(kvtier=True)``); a misrouted call
  answers 403
- ``POST /v1/completions``, ``POST /v1/chat/completions``, ``GET
  /v1/models`` with ``api=True`` (``bigdl.llm.api.enabled``): the
  OpenAI gateway (``llm/api``), 404 naming the gate otherwise.
- ``GET /worker_drain`` / ``POST /worker_drain`` {"action":
  "begin"|"cancel", "peers", "timeout"} with ``fleet=True``
  (``bigdl.llm.fleet.enabled``): the graceful drain of
  :class:`~bigdl_tpu_torch.llm.fleet.DrainCoordinator`, 404 otherwise.
- ``GET /metrics/query``, ``/fleet/timeline`` and ``/alerts`` with
  ``bigdl.observability.timeseries.enabled``: the time-series store and
  the alert engine (``observability/timeseries.py``, ``alerts.py``),
  404 naming the gate otherwise.

Submission splits failures 422 (invalid request) / 503 + Retry-After
(the engine's ``OverloadError``: queue full, draining) / 500 (anything
else); ``X-BigDL-Deadline-Ms`` caps the wait; the generate endpoints
read and echo ``X-BigDL-Trace-Id`` so the engine's spans stitch under
the caller's trace.

Handler threads stay on the host: they pass numpy ids to ``submit`` and
read host state only (the engine thread alone runs device work under
``torch.inference_mode``).

With ``federation=True`` (``bigdl.observability.federation``) the
worker serves ``GET /metrics/snapshot``, its registry as the fleet
collector's JSON document (404 otherwise).

:class:`LLMRouter` — the port of the JAX router — places requests over
prefill and decode worker pools of either package (the wire is the JAX
package's): per-backend circuit breakers, 503 + Retry-After when no
decode backend is admittable, the trace / deadline / priority headers
relayed, the prefill → import → decode handoff with graceful
degradation; with ``failover=True`` the request journal, mid-stream
resume on another backend, the ``/healthz`` prober and live
``POST /backends`` membership; with ``hedge=True`` hedged dispatch;
with ``federation=True`` the merged fleet ``/metrics`` and
``/fleet/status``; with ``api=True`` the OpenAI gateway over the
journal; with ``fleet=True`` (failover mode only) the autoscaler,
:class:`~bigdl_tpu_torch.llm.fleet.FleetController`, and
``/fleet/autoscaler``; with the time-series plane on, ``/metrics/query``,
``/fleet/timeline`` (riding the federation collector's cache) and
``/alerts``. Router code touches HTTP and host state only, never an
engine.
"""

from __future__ import annotations

import base64
import http.client
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.observability import alerts
from bigdl_tpu_torch.observability import flight
from bigdl_tpu_torch.observability import request_context as rc
from bigdl_tpu_torch.observability import timeseries
from bigdl_tpu_torch.observability import tracing
from bigdl_tpu_torch.observability.federation import (
    federation_enabled, registry_snapshot)

ROLES = ("", "prefill", "decode")

# SLO-class header: case-insensitive (HTTPMessage lookups
# already are), propagated router→worker beside the trace and deadline
# headers
PRIORITY_HEADER = "X-BigDL-Priority"


class _QuietHTTPServer(ThreadingHTTPServer):
    """Abandoned client connections are ROUTINE on these surfaces
    : the loser of a hedge race is cancelled mid-stream, and a
    failover re-dispatch closes the dead attempt's socket — the default
    stderr traceback for a peer reset is pure noise. Real handler
    errors still print."""

    def handle_error(self, request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError)):
            return
        super().handle_error(request, client_address)


def _send_json(handler, code: int, obj, headers=()):
    """Shared JSON response for the worker and router handlers: body,
    custom headers, and the request's trace-id echo (absent in disabled
    mode). Keep-alive reuses handlers — ``_trace`` is reset at the top
    of every do_GET/do_POST, so no cross-request leak."""
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    for k, v in headers:
        handler.send_header(k, v)
    trace_id = getattr(handler, "_trace", None)
    if trace_id:
        handler.send_header(rc.TRACE_HEADER, trace_id)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class LLMWorker:
    """The HTTP surface over one :class:`~bigdl_tpu_torch.llm.serving.
    LLMServer` (see the module docstring); ``start()`` serves on a
    thread, ``address`` is the bound ``(host, port)``."""

    def __init__(self, server, model_name: str = "bigdl-tpu-llm",
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 600.0,
                 role: Optional[str] = None,
                 federation: Optional[bool] = None,
                 fleet: Optional[bool] = None,
                 api: Optional[bool] = None,
                 tokenizer=None):
        from bigdl_tpu_torch.utils.conf import conf
        self.server = server
        self.model_name = model_name
        self.request_timeout = request_timeout
        self.role = (role if role is not None
                     else conf.get("bigdl.llm.role", "") or "")
        if self.role not in ROLES:
            raise ValueError(f"bigdl.llm.role must be one of {ROLES}, "
                             f"got {self.role!r}")
        # fleet federation member surface: /metrics/snapshot exists
        # only when the federation plane is on — a disabled worker keeps
        # the endpoint structurally absent (404)
        self.federation = federation_enabled(federation)
        # elastic fleet drain: constructed ONLY when
        # bigdl.llm.fleet.enabled — disabled mode has no drain state
        # and /worker_drain answers 404 (structural absence)
        fleet_on = (fleet if fleet is not None else
                    conf.get_bool("bigdl.llm.fleet.enabled", False))
        self._drain = None
        if fleet_on:
            from bigdl_tpu_torch.llm.fleet import DrainCoordinator
            self._drain = DrainCoordinator(server)
        # OpenAI-compatible gateway: constructed ONLY when
        # bigdl.llm.api.enabled — disabled mode keeps /v1/* answering
        # 404 naming the gate and mints no bigdl_api_* series
        api_on = (api if api is not None else
                  conf.get_bool("bigdl.llm.api.enabled", False))
        self._api = None
        if api_on:
            from bigdl_tpu_torch.llm.api.gateway import (EngineBackend,
                                                   OpenAIGateway)
            self._api = OpenAIGateway(
                EngineBackend(server, model_name,
                              request_timeout=request_timeout),
                tokenizer=tokenizer, scope="worker")
        self._t0 = time.time()
        self._tokens_out = 0
        worker = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code: int, obj, headers=()):
                _send_json(self, code, obj, headers)

            def _read_req(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                ids = np.asarray(req["prompt_ids"], np.int32)
                return ids, int(req.get("max_new_tokens", 32))

            def _submit(self, ids, mnt):
                """submit with the 422/503/500 split: invalid requests
                are the client's fault, overload is shed with
                Retry-After, and any other failure (including an
                injected one — InjectedFault is deliberately NOT
                special-cased, per the faults.py contract) answers 500
                instead of killing the handler's connection."""
                pri = self.headers.get(PRIORITY_HEADER)
                try:
                    # the kwarg is passed only when the header is
                    # present: stub servers in tests (and any
                    # priority-unaware engine) keep working unchanged
                    kw = {"priority": pri} if pri is not None else {}
                    return worker.server.submit(ids, max_new_tokens=mnt,
                                                **kw)
                except reliability.OverloadError as e:
                    # page accounting rides the Retry-After diagnostics
                    #: pages_needed is the POST-
                    # LOOKUP suffix cost, so clients see how far the
                    # prefix cache already got them
                    body = {"error": str(e)}
                    for key in ("pages_needed", "pages_free"):
                        val = getattr(e, key, None)
                        if val is not None:
                            body[key] = int(val)
                    if getattr(e, "draining", False):
                        # drain shed: a structured field the
                        # router's bounce keys on — never the wording
                        body["draining"] = True
                    # Retry-After derived from observed queue depth
                    # — a deep backlog tells
                    # clients to back off longer, jitter decorrelates
                    # the retry herd. With the priority scheduler the
                    # depth is class-weighted:
                    # batch clients back off harder than interactive
                    # ones under the SAME backlog.
                    rd = getattr(worker.server, "retry_depth", None)
                    if rd is not None:
                        depth = rd(pri)
                    else:
                        q = getattr(worker.server, "_queue", None)
                        depth = q.qsize() if q is not None else 0
                    self._json(503, body, headers=(
                        ("Retry-After",
                         reliability.retry_after_seconds(depth)),))
                    return None
                except ValueError as e:
                    self._json(422, {"error": str(e)})
                    return None
                except Exception as e:  # noqa: BLE001 — real or injected
                    self._json(500, {"error": f"submit failed: {e}"})
                    return None

            def _wait_timeout(self) -> float:
                deadline = reliability.Deadline.from_header(
                    self.headers.get(reliability.DEADLINE_HEADER))
                if deadline is None:
                    return worker.request_timeout
                return max(min(worker.request_timeout,
                               deadline.remaining()), 0.0)

            def do_GET(self):
                self._trace = None
                debug = tracing.debug_endpoint(self.path)
                if debug is None:
                    # flight recorder + per-request explain: same
                    # shared-helper idiom, 404 arms included
                    debug = flight.debug_endpoint(self.path)
                if debug is None:
                    # time-series plane: /metrics/query +
                    # /fleet/timeline + /alerts, 404 arms included
                    debug = timeseries.debug_endpoint(self.path)
                if debug is None:
                    debug = alerts.debug_endpoint(self.path)
                if debug is not None:
                    self._json(*debug)
                elif self.path == "/debug/kvcache":
                    # prefix-cache state: pool refcounts,
                    # radix index size, hit/miss/evict tallies. 404
                    # when the cache is disabled — the surface is
                    # structurally absent, not empty
                    kv = getattr(worker.server, "_kv", None)
                    if kv is None or not kv.enabled:
                        self._json(404, {"error": "kvcache disabled"})
                    else:
                        self._json(200, kv.debug_stats())
                elif self.path == "/worker_drain":
                    # drain status poll: 404 when the fleet
                    # plane is off — structurally absent, not idle
                    if worker._drain is None:
                        self._json(404, {"error": "fleet disabled"})
                    else:
                        self._json(200, worker._drain.status())
                elif self.path == "/v1/models":
                    # OpenAI surface: 404 when the gateway
                    # is off — structurally absent, naming the gate
                    if worker._api is None:
                        self._json(404, {"error": "api disabled "
                                         "(bigdl.llm.api.enabled)"})
                    else:
                        worker._api.handle_models(self)
                elif self.path == "/worker_get_status":
                    dt = max(time.time() - worker._t0, 1e-9)
                    status = {
                        "model": worker.model_name,
                        "role": worker.role,
                        "queue_length": worker.server._queue.qsize(),
                        "steps": worker.server.steps,
                        "speed": round(worker._tokens_out / dt, 2)}
                    cd = getattr(worker.server, "class_depths", None)
                    depths = cd() if cd is not None else None
                    if depths is not None:
                        # absent when the scheduler is off
                        status["queue_by_class"] = depths
                        status["preempt_parked"] = \
                            worker.server.preempt_parked
                    self._json(200, status)
                elif self.path == "/metrics":
                    # same Prometheus surface as the cluster-serving
                    # frontend: prefill/decode tokens, KV occupancy, …
                    from bigdl_tpu_torch import observability as obs
                    body = obs.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", obs.CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/metrics/snapshot":
                    # federation member surface: the full registry as
                    # JSON incl. sketch state (and the live roofline
                    # with the flight recorder on), for the fleet
                    # collector's label-aware merge. 404 when the
                    # federation plane is off — structurally absent
                    if not worker.federation:
                        self._json(404,
                                   {"error": "federation disabled"})
                    else:
                        addr = worker.address
                        self._json(200, registry_snapshot(
                            instance=f"{addr[0]}:{addr[1]}"))
                elif self.path == "/healthz":
                    ok, report = reliability.health_report()
                    engine = worker.server._thread
                    alive = engine is not None and engine.is_alive()
                    draining = worker.server._draining.is_set() \
                        if hasattr(worker.server, "_draining") else False
                    # watchdog: a stalled engine answers 503
                    # so the router's prober drains this worker; the
                    # key is structurally absent when the watchdog is
                    # off (disabled-mode byte-compat)
                    tripped = bool(getattr(worker.server,
                                           "watchdog_tripped", False))
                    healthy = ok and alive and not draining \
                        and not tripped
                    body = {
                        "status": ("ok" if healthy else
                                   "draining" if draining else
                                   "stalled" if tripped else
                                   "unhealthy"),
                        "role": worker.role,
                        "engine_alive": alive,
                        "queue_length": worker.server._queue.qsize(),
                        "checks": report}
                    if getattr(worker.server, "watchdog_enabled",
                               False):
                        body["watchdog"] = {
                            "tripped": tripped,
                            "trips": worker.server.watchdog_trips,
                            "step_timeout_s":
                                worker.server.watchdog_timeout}
                    # rolling SLO burn rate: absent when
                    # bigdl.slo.enabled is off
                    slo = getattr(worker.server, "_slo", None)
                    if slo is not None:
                        body["slo"] = slo.status()
                    # priority scheduler: per-class backlog
                    # and preempted-parked count, keys structurally
                    # absent when bigdl.llm.priority.enabled is off —
                    # the fleet's scale-in victim filter and class-
                    # pressure signal read these without federation
                    cd = getattr(worker.server, "class_depths", None)
                    depths = cd() if cd is not None else None
                    if depths is not None:
                        body["queue_by_class"] = depths
                        body["preempt_parked"] = \
                            worker.server.preempt_parked
                    self._json(200 if healthy else 503, body)
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                self._trace = None
                ctx = None
                if self.path in ("/worker_generate",
                                 "/worker_generate_stream",
                                 "/worker_prefill",
                                 "/worker_import_chain",
                                 "/v1/completions",
                                 "/v1/chat/completions"):
                    # case-insensitive trace extraction (or a fresh
                    # root); None in disabled mode — no headers emitted
                    ctx = rc.server_context(self.headers)
                    if ctx is not None:
                        self._trace = ctx.trace_id
                # role gating: a prefill-pool worker never
                # decodes full requests, a decode-pool worker never
                # serves the prefill/export side — misrouted calls are
                # the router's bug and answer 403, not a silent detour
                if worker.role == "prefill" and self.path in (
                        "/worker_generate", "/worker_generate_stream",
                        "/v1/completions", "/v1/chat/completions"):
                    self._json(403, {"error": "prefill-role worker: "
                                     "use /worker_prefill"})
                    return
                if worker.role == "decode" and \
                        self.path == "/worker_prefill":
                    self._json(403, {"error": "decode-role worker "
                                     "does not prefill"})
                    return
                if worker.role == "prefill" and \
                        self.path == "/worker_import_chain":
                    self._json(403, {"error": "prefill-role worker "
                                     "does not import chains"})
                    return
                if self.path in ("/v1/completions",
                                 "/v1/chat/completions"):
                    # OpenAI surface: direct engine drain
                    # on the single-node worker; 404 naming the gate
                    # when off — structurally absent
                    if worker._api is None:
                        self._json(404, {"error": "api disabled "
                                         "(bigdl.llm.api.enabled)"})
                        return
                    with rc.activate(ctx):
                        worker._api.handle_post(self, self.path)
                    return
                if self.path == "/worker_drain":
                    # graceful drain control: begin flips
                    # the engine to DRAINING and starts the finish-
                    # then-migrate thread; cancel resumes admission.
                    # 404 when the fleet plane is off.
                    if worker._drain is None:
                        self._json(404, {"error": "fleet disabled"})
                        return
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(n)) if n \
                            else {}
                        action = body.get("action", "begin")
                        if action not in ("begin", "cancel"):
                            raise ValueError(
                                "action must be begin|cancel")
                        # coerce peers/timeout HERE: malformed values
                        # are the client's 400, not a torn connection
                        peers = [(str(p[0]), int(p[1]))
                                 for p in body.get("peers", [])]
                        drain_timeout = float(body.get("timeout", 60.0))
                    except Exception as e:  # noqa: BLE001
                        self._json(400, {"error": f"bad request: {e}"})
                        return
                    if action == "cancel":
                        worker._drain.cancel()
                        self._json(200, worker._drain.status())
                        return
                    started = worker._drain.begin(
                        peers, timeout=drain_timeout)
                    if not started:
                        self._json(409, {
                            "error": "drain already active",
                            **worker._drain.status()})
                        return
                    self._json(200, worker._drain.status())
                    return
                if self.path == "/worker_prefill":
                    # run the prompt once (one decoded token pins the
                    # chain in the index), then export its KV pages as
                    # the handoff blob
                    try:
                        ids, _ = self._read_req()
                    except Exception as e:  # noqa: BLE001
                        self._json(400, {"error": f"bad request: {e}"})
                        return
                    with rc.activate(ctx), \
                            obs.span("llm/handoff_export",
                                     stage="llm_worker",
                                     tokens=len(ids)):
                        req = self._submit(ids, 1)
                        if req is None:
                            return
                        try:
                            toks = req.get(timeout=self._wait_timeout())
                        except TimeoutError:
                            self._json(504,
                                       {"error": "prefill timed out"})
                            return
                        except RuntimeError as e:
                            self._json(500, {"error": str(e)})
                            return
                        try:
                            blob = worker.server.export_chain(ids)
                        except RuntimeError as e:   # tier disabled
                            self._json(501, {"error": str(e)})
                            return
                    worker._tokens_out += len(toks)
                    self._json(200, {
                        "handoff": base64.b64encode(blob).decode(),
                        "handoff_bytes": len(blob),
                        "output_ids": list(map(int, toks))})
                    return
                if self.path == "/worker_import_chain":
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(n))
                        blob = base64.b64decode(body["handoff"])
                    except Exception as e:  # noqa: BLE001
                        self._json(400, {"error": f"bad request: {e}"})
                        return
                    with rc.activate(ctx), \
                            obs.span("llm/handoff_import",
                                     stage="llm_worker",
                                     bytes=len(blob)):
                        try:
                            pages = worker.server.import_chain(blob)
                        except RuntimeError as e:   # tier disabled
                            self._json(501, {"error": str(e)})
                            return
                        except ValueError as e:     # malformed blob
                            self._json(422, {"error": str(e)})
                            return
                    self._json(200, {"imported_pages": pages})
                    return
                if self.path == "/worker_generate":
                    try:
                        ids, mnt = self._read_req()
                    except Exception as e:  # noqa: BLE001
                        self._json(400, {"error": f"bad request: {e}"})
                        return
                    t_req = time.perf_counter()
                    with rc.activate(ctx), \
                            obs.span("llm/request", stage="llm_worker",
                                     max_new_tokens=mnt):
                        req = self._submit(ids, mnt)
                        if req is None:
                            return
                        try:
                            toks = req.get(timeout=self._wait_timeout())
                        except TimeoutError:
                            # timed-out requests are by definition the
                            # slowest — excluding them would make the
                            # exemplar store lie about the tail
                            if ctx is not None:
                                obs.EXEMPLARS.offer(
                                    ctx.trace_id,
                                    time.perf_counter() - t_req,
                                    name="llm/request", request=req.id,
                                    status="timeout")
                            self._json(504,
                                       {"error": "generation timed out"})
                            return
                        except RuntimeError as e:  # engine failed it
                            self._json(500, {"error": str(e)})
                            return
                    if ctx is not None:
                        obs.EXEMPLARS.offer(
                            ctx.trace_id, time.perf_counter() - t_req,
                            name="llm/request", request=req.id,
                            status="ok", tokens=len(toks))
                    worker._tokens_out += len(toks)
                    eos = worker.server.eos_token_id
                    reason = ("stop" if eos is not None and toks
                              and toks[-1] == eos else "length")
                    self._json(200, {"output_ids": list(map(int, toks)),
                                     "finish_reason": reason})
                elif self.path == "/worker_generate_stream":
                    try:
                        ids, mnt = self._read_req()
                    except Exception as e:  # noqa: BLE001
                        self._json(400, {"error": f"bad request: {e}"})
                        return
                    with rc.activate(ctx):
                        req = self._submit(ids, mnt)
                    if req is None:
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/json-lines")
                    self.send_header("Transfer-Encoding", "chunked")
                    if ctx is not None:
                        self.send_header(rc.TRACE_HEADER, ctx.trace_id)
                    self.end_headers()

                    def chunk(obj):
                        data = (json.dumps(obj) + "\n").encode()
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data
                            + b"\r\n")
                        self.wfile.flush()

                    seen = 0
                    done = False
                    deadline = time.time() + self._wait_timeout()
                    try:
                        while time.time() < deadline:
                            done = req.done.wait(0.02)
                            cur = list(req.tokens)
                            eos = worker.server.eos_token_id
                            if not done and req.error is None \
                                    and eos is not None and cur \
                                    and cur[-1] == eos:
                                # a chunk ending in EOS is ALWAYS
                                # terminal: the engine is
                                # about to finish this request with
                                # "stop". A done:false chunk carrying
                                # EOS would let a mid-stream failover
                                # journal it, resume past it on
                                # another backend, and generate
                                # spurious post-EOS tokens.
                                done = True
                            if len(cur) > seen or done:
                                seen = len(cur)
                                payload = {
                                    "output_ids": list(map(int, cur)),
                                    "done": bool(done)}
                                if done:
                                    # terminal chunk carries the same
                                    # verdict the blocking endpoint
                                    # returns: either the
                                    # finish reason, or the engine's
                                    # error so the router can fail
                                    # over with the tokens so far
                                    if req.error is not None:
                                        payload["error"] = req.error
                                        payload["retriable"] = True
                                    else:
                                        eos = worker.server.eos_token_id
                                        payload["finish_reason"] = (
                                            "stop" if eos is not None
                                            and cur and cur[-1] == eos
                                            else "length")
                                chunk(payload)
                            if done:
                                break
                        if not done:
                            # timed out: a stream must never end with
                            # done:false — clients reading until
                            # done:true would see a silent truncation
                            cur = list(req.tokens)
                            eos = worker.server.eos_token_id
                            if eos is not None and cur \
                                    and cur[-1] == eos:
                                # the engine appended EOS in the
                                # window between the last wait-loop
                                # snapshot and deadline expiry: this
                                # is a FINISHED answer, not a stall.
                                # Labeling it "timeout" (retriable)
                                # would let failover resume past EOS
                                # and append spurious tokens — the
                                # same corruption the in-loop EOS
                                # guard exists to prevent.
                                chunk({"output_ids":
                                       list(map(int, cur)),
                                       "done": True,
                                       "finish_reason": "stop"})
                            else:
                                chunk({"output_ids":
                                       list(map(int, cur)),
                                       "done": True,
                                       "finish_reason": "timeout"})
                                # the router treats "timeout" as
                                # retriable and resumes elsewhere —
                                # abort the orphan so a merely-slow
                                # engine frees its slot and KV pages
                                # instead of double-computing tokens
                                # nobody will read
                                abort = getattr(worker.server,
                                                "abort", None)
                                if abort is not None:
                                    abort(req, reason="stream wait "
                                          "expired")
                        worker._tokens_out += seen
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                    except OSError:
                        # client gone mid-stream — the loser of a hedge
                        # race, cancelled: abort the request
                        # so its slot and KV pages free instead of
                        # decoding tokens nobody will read
                        abort = getattr(worker.server, "abort", None)
                        if abort is not None:
                            abort(req, reason="client disconnected "
                                  "mid-stream")
                        worker._tokens_out += seen
                        self.close_connection = True
                else:
                    self._json(404, {"error": "unknown path"})

        self._httpd = _QuietHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address
        self._thread: Optional[object] = None

    def start(self) -> "LLMWorker":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        # time-series plane: refcounted — released on stop
        self._timeseries = timeseries.acquire()
        return self

    def stop(self):
        # shutdown during an active drain: cancel and JOIN the drain
        # thread first — after this there are no orphaned migration
        # posts and no drain-held state; resume=False keeps admission
        # closed (the engine is about to stop for good)
        if self._drain is not None:
            self._drain.cancel(resume=False)
        if getattr(self, "_timeseries", None) is not None:
            timeseries.release()
            self._timeseries = None
        if self._thread is not None:
            # shutdown() handshakes with serve_forever — calling it on
            # a never-started server would wait forever
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        self._httpd.server_close()


def _post_json(addr: Tuple[str, int], path: str, body: dict,
               headers=(), timeout: float = 600.0, canceller=None):
    """One JSON POST to a backend worker → (status, parsed body,
    response headers dict). Connection errors raise — the router's
    breaker accounting wants them loud. ``canceller`` lets a
    hedge race close this connection from another thread."""
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    if canceller is not None:
        canceller.attach(conn)
    try:
        payload = json.dumps(body)
        hdrs = {"Content-Type": "application/json"}
        for k, v in headers:
            hdrs[k] = v
        conn.request("POST", path, payload, hdrs)
        resp = conn.getresponse()
        data = resp.read()
        try:
            parsed = json.loads(data.decode())
        except ValueError:
            parsed = {"error": data.decode(errors="replace")[:200]}
        # resp.msg is the parsed HTTPMessage: case-insensitive .get,
        # still readable after the connection closes
        return resp.status, parsed, resp.msg
    finally:
        conn.close()


class _BackendShed(Exception):
    """503 from a backend: alive, applying backpressure. Relayed with
    its own Retry-After — never retried, never a breaker failure."""

    def __init__(self, parsed, retry_after):
        super().__init__(parsed.get("error", "backend shedding"))
        self.parsed = parsed
        self.retry_after = retry_after


class _BackendDraining(Exception):
    """503 whose body says the worker is DRAINING: alive,
    finishing its in-flight streams, taking no new work. NOT a breaker
    failure and NOT client-visible backpressure — the router marks the
    backend draining at the prober and re-routes the request to another
    backend instead of relaying the shed."""

    def __init__(self, parsed):
        super().__init__(parsed.get("error", "backend draining"))
        self.parsed = parsed


class _BackendFatal(Exception):
    """A 4xx from a backend: the *request* is bad (422 infeasible, 403
    misroute), not the backend — relayed as-is, never failed over."""

    def __init__(self, status, parsed):
        super().__init__(parsed.get("error", f"backend answered {status}"))
        self.status = status
        self.parsed = parsed


class _RouteError(Exception):
    """Typed carrier for a failover-routing outcome that must surface
    as an HTTP error. ``_route_failover`` renders it through
    ``handler._json``; the
    OpenAI gateway's router backend maps it onto OpenAI error objects
    (503 → 429 ``rate_limit_exceeded`` keeping the Retry-After)."""

    def __init__(self, status, body, headers=()):
        super().__init__(body.get("error", f"status {status}"))
        self.status = status
        self.body = body
        self.headers = tuple(headers)


class _ApiRouterBackend:
    """OpenAI-gateway backend over the router's failover dispatch
   : ``generate`` runs the same journal + resume loop as
    ``POST /worker_generate``, with the gateway's per-delta callback
    installed as the journal entry's drain listener — the SSE chunk
    emission and the router SLO arrival stamps happen at the same
    drain event, so client-visible TTFT/ITL and the
    ``bigdl_router_{ttft,itl}_seconds`` sketches are one accounting.
    Routed pools run greedy decode (the failover bit-parity contract
    requires determinism), so ``sampling()`` reports greedy."""

    def __init__(self, router, model_name: str):
        self.router = router
        self.model_name = model_name
        self.request_timeout = router.request_timeout

    def sampling(self):
        return (0.0, 0)

    def generate(self, prompt_ids, max_new_tokens, priority, deadline,
                 on_delta):
        from bigdl_tpu_torch.llm.api.errors import error_for_status
        body = {"prompt_ids": [int(t) for t in prompt_ids],
                "max_new_tokens": int(max_new_tokens)}
        ctx = rc.current()

        def fwd_headers():
            hdrs = list(rc.to_headers(ctx))
            if deadline is not None:
                hdrs.append((reliability.DEADLINE_HEADER,
                             deadline.to_header()))
            if priority is not None:
                hdrs.append((PRIORITY_HEADER, priority))
            return hdrs

        try:
            ent = self.router._dispatch_failover(
                body, fwd_headers, deadline, priority=priority,
                listener=on_delta)
        except _RouteError as e:
            raise error_for_status(
                e.status,
                e.body.get("error", f"routing failed ({e.status})"),
                retry_after=dict(e.headers).get("Retry-After"))
        return [int(t) for t in ent.tokens], \
            ent.finish_reason or "length"


#: Prometheus encoding of breaker states:
#: closed=0, half_open=1, open=2 — so an alerting rule is `> 1`.
BREAKER_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


class LLMRouter:
    """Placement scheduler over disaggregated worker pools,
    grown into the reliability boundary of the serving stack.

    ``POST /worker_generate`` routes one request end-to-end:

    1. pick a prefill backend (round-robin over the pool, skipping open
       circuit breakers and prober-unhealthy backends) →
       ``/worker_prefill`` → handoff blob;
    2. pick a decode backend the same way → ``/worker_import_chain``
       (best-effort) then decode → relay the answer.

    **Request-level failover** (``bigdl.llm.failover.enabled`` /
    ``failover=`` ctor arg; default off). When enabled the router drains
    decode through the worker's *streaming* endpoint and journals every
    token as it arrives (:class:`~bigdl_tpu_torch.llm.failover.
    RequestJournal`). A connection failure / 5xx / mid-generation engine
    error re-dispatches ``prompt + generated_so_far`` to another backend
    with the remaining token budget — greedy decoding is deterministic,
    so the spliced output is the unfailed run's (bit for bit on the CPU
    in f32; on the card the resumed suffix is prefilled where the first
    backend decoded it, so bf16 sums may part), and the backend's radix
    cache / host tier make the resume a short suffix prefill. Worker
    loss costs latency, not answers. Alongside it:

    - an active :class:`~bigdl_tpu_torch.llm.failover.HealthProber` polls
      worker ``/healthz`` so ``_pick`` routes on observed health, and
      ``POST /backends`` joins/leaves pool members without a restart;
    - **hedged dispatch** (``bigdl.llm.hedge.enabled``): a prefill or
      decode call slower than the stage's observed p95 is duplicated to
      a second backend — first success wins, the loser's connection is
      closed and the worker aborts it, releasing its KV. Bounded by
      ``bigdl.llm.hedge.budget``;
    - every outgoing backend call re-derives the remaining
      ``X-BigDL-Deadline-Ms`` from elapsed time, so retries and hedges
      never overstate the budget.

    Disabled (both knobs false, the default) the router is the plain
    placement scheduler: blocking dispatch, no journal, no prober
    thread, no failover/hedge metric series.

    With ``federation=True`` (``bigdl.observability.federation``) a
    :class:`~bigdl_tpu_torch.observability.federation.FederationCollector`
    scrapes every member's ``/metrics/snapshot``: ``GET /metrics`` serves
    the merged fleet view (the router's own registry as instance
    ``"router"``) and ``GET /fleet/status`` the members' staleness.
    ``api=True`` serves the OpenAI gateway over the failover journal.
    ``fleet=True`` (``bigdl.llm.fleet.enabled``; failover mode only)
    embeds the :class:`~bigdl_tpu_torch.llm.fleet.FleetController`
    autoscaler over ``provider`` (``fleet_opts`` its bounds and knobs,
    ``start_fleet=False`` to tick it by hand) and serves
    ``GET /fleet/autoscaler``.

    Reused machinery, not re-invented: per-backend
    :class:`~bigdl_tpu_torch.reliability.CircuitBreaker` trips on connection
    failures/5xx, overload sheds with **503 + Retry-After** (derived
    from ``bigdl.llm.retry_after.*``; a backend's own Retry-After is
    relayed unchanged), and the trace context rides
    ``X-BigDL-Trace-Id`` into every backend so ``GET
    /debug/trace/<id>`` shows the stitched router → prefill → decode
    waterfall, with ``router/failover``/``router/hedge`` spans marking
    the recovery path. A failed prefill stage degrades gracefully: the
    decode backend prefills itself.
    """

    def __init__(self, prefill_workers: List[Tuple[str, int]],
                 decode_workers: List[Tuple[str, int]],
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 600.0,
                 breaker_threshold: int = 3,
                 breaker_reset: float = 10.0,
                 failover: Optional[bool] = None,
                 hedge: Optional[bool] = None,
                 failover_attempts: Optional[int] = None,
                 hedge_delay_ms: Optional[float] = None,
                 prober_interval: Optional[float] = None,
                 start_prober: bool = True,
                 slo: Optional[bool] = None,
                 federation: Optional[bool] = None,
                 fleet: Optional[bool] = None,
                 provider=None,
                 fleet_opts: Optional[dict] = None,
                 start_fleet: bool = True,
                 api: Optional[bool] = None,
                 model_name: str = "bigdl-tpu-llm",
                 tokenizer=None):
        from bigdl_tpu_torch.utils.conf import conf
        if not decode_workers:
            raise ValueError("the router needs at least one "
                             "decode-role backend")
        self.prefill_workers = [tuple(a) for a in prefill_workers]
        self.decode_workers = [tuple(a) for a in decode_workers]
        self.request_timeout = request_timeout
        self._breaker_threshold = breaker_threshold
        self._breaker_reset = breaker_reset
        self._pool_lock = threading.RLock()
        self._rr = {"prefill": 0, "decode": 0}
        self._breakers = {}
        for addr in self.prefill_workers + self.decode_workers:
            self._breaker_for(addr)   # the one get-or-create path
        self.requests_routed = 0
        self.handoffs_routed = 0
        self.prefill_degraded = 0
        # failover + hedging are constructed ONLY when enabled — the
        # disabled router carries none of their state
        self.failover_enabled = (
            failover if failover is not None else
            conf.get_bool("bigdl.llm.failover.enabled", False))
        hedge_on = (hedge if hedge is not None else
                    conf.get_bool("bigdl.llm.hedge.enabled", False))
        self._active = self.failover_enabled or hedge_on
        self.max_attempts = max(1, (
            failover_attempts if failover_attempts is not None else
            conf.get_int("bigdl.llm.failover.max.attempts", 3)))
        self._journal = None
        self._prober = None
        self._hedge = None
        self._latency = None
        self._start_prober = False
        if self._active:
            from bigdl_tpu_torch.llm.failover import (
                HealthProber, HedgePolicy, LatencyTracker, RequestJournal)
            self._journal = RequestJournal()
            self._hedge = HedgePolicy(
                enabled=hedge_on,
                delay_ms=(hedge_delay_ms if hedge_delay_ms is not None
                          else conf.get_float("bigdl.llm.hedge.delay.ms",
                                              0.0)),
                min_delay_ms=conf.get_float(
                    "bigdl.llm.hedge.min.delay.ms", 50.0),
                budget=conf.get_float("bigdl.llm.hedge.budget", 0.1))
            self._latency = {"prefill": LatencyTracker(),
                             "decode": LatencyTracker()}
            if self.failover_enabled:
                self._prober = HealthProber(
                    self._prober_targets,
                    interval=(prober_interval if prober_interval
                              is not None else
                              conf.get_float("bigdl.llm.prober.interval",
                                             0.5)),
                    on_probe=self._on_probe)
                self._start_prober = start_prober
        # client-visible SLO accounting: TTFT/ITL from the
        # journal's streamed-token timestamps — only meaningful in
        # failover mode (the blocking path streams nothing), and
        # only constructed when bigdl.slo.enabled says so
        self._slo = None
        if self._active:
            from bigdl_tpu_torch.observability.slo import SLOAccount
            self._slo = SLOAccount.if_enabled("router", enabled=slo)
        # fleet metric federation: a background collector
        # scraping every pool member's /metrics/snapshot; constructed
        # ONLY when bigdl.observability.federation is on — disabled
        # mode has no collector thread and the fleet endpoints 404
        self._collector = None
        if federation_enabled(federation):
            from bigdl_tpu_torch.observability.federation import (
                FederationCollector)
            self._collector = FederationCollector(
                self._federation_targets, include_self="router")
        # elastic fleet autoscaler: constructed ONLY when
        # bigdl.llm.fleet.enabled — disabled mode has no controller
        # thread, no bigdl_fleet_* series, and /fleet/autoscaler 404s
        fleet_on = (fleet if fleet is not None else
                    conf.get_bool("bigdl.llm.fleet.enabled", False))
        self._fleet = None
        self._start_fleet = False
        if fleet_on:
            if not self.failover_enabled:
                raise ValueError(
                    "bigdl.llm.fleet needs bigdl.llm.failover.enabled: "
                    "the autoscaler drives the prober and the live "
                    "POST /backends membership")
            from bigdl_tpu_torch.llm.fleet import FleetController
            self._fleet = FleetController(self, provider=provider,
                                          **(fleet_opts or {}))
            self._start_fleet = start_fleet
        # OpenAI-compatible gateway: constructed ONLY when
        # bigdl.llm.api.enabled. On the router it REQUIRES failover
        # mode — the SSE relay streams from the failover journal's
        # drain (the per-token listener), and the blocking path
        # streams nothing to relay.
        self.model_name = model_name
        api_on = (api if api is not None else
                  conf.get_bool("bigdl.llm.api.enabled", False))
        self._api = None
        if api_on:
            if not self.failover_enabled:
                raise ValueError(
                    "bigdl.llm.api needs bigdl.llm.failover.enabled "
                    "on the router: the SSE relay drains the failover "
                    "journal")
            from bigdl_tpu_torch.llm.api.gateway import OpenAIGateway
            self._api = OpenAIGateway(
                _ApiRouterBackend(self, model_name),
                tokenizer=tokenizer, scope="router")
        self._ins = None
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code: int, obj, headers=()):
                _send_json(self, code, obj, headers)

            def do_GET(self):
                self._trace = None
                debug = tracing.debug_endpoint(self.path)
                if debug is None:
                    # router surface of the flight recorder:
                    # the journal's failover/hedge/shed events live in
                    # this process, so explain works here too
                    debug = flight.debug_endpoint(self.path)
                if debug is None:
                    # time-series plane: with the collector
                    # attached, /fleet/timeline serves per-member +
                    # merged series off the scrape cache
                    debug = timeseries.debug_endpoint(self.path)
                if debug is None:
                    debug = alerts.debug_endpoint(self.path)
                if debug is not None:
                    self._json(*debug)
                elif self.path == "/healthz":
                    self._json(*router._healthz())
                elif self.path == "/metrics":
                    router._record_breakers()
                    if router._collector is not None:
                        # fleet view: members' cached
                        # snapshots merged label-aware, the router's
                        # own registry riding along as instance
                        # "router". Render only reads the collector
                        # cache — a dead member can never stall this.
                        body = router._collector.render().encode()
                    else:
                        body = obs.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", obs.CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/fleet/status":
                    if router._collector is None:
                        self._json(404,
                                   {"error": "federation disabled"})
                    else:
                        self._json(200, router._collector.status())
                elif self.path == "/fleet/autoscaler":
                    # autoscaler state: 404 when the fleet
                    # plane is off — structurally absent, not idle
                    if router._fleet is None:
                        self._json(404, {"error": "fleet disabled"})
                    else:
                        self._json(200, router._fleet.status())
                elif self.path == "/v1/models":
                    # OpenAI surface: 404 when the gateway
                    # is off — structurally absent, naming the gate
                    if router._api is None:
                        self._json(404, {"error": "api disabled "
                                         "(bigdl.llm.api.enabled)"})
                    else:
                        router._api.handle_models(self)
                elif self.path == "/worker_get_status":
                    self._json(200, router._status_body())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                self._trace = None
                if self.path == "/backends":
                    # live pool membership: part of the
                    # active-health layer, 404 when failover is off
                    if not router.failover_enabled:
                        self._json(404, {"error": "unknown path"})
                        return
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(n))
                        code, out = router._admin_backends(body)
                    except Exception as e:  # noqa: BLE001
                        self._json(400, {"error": f"bad request: {e}"})
                        return
                    self._json(code, out)
                    return
                if self.path in ("/v1/completions",
                                 "/v1/chat/completions"):
                    # OpenAI surface: SSE relay from the
                    # failover journal drain; 404 naming the gate when
                    # off — structurally absent
                    if router._api is None:
                        self._json(404, {"error": "api disabled "
                                         "(bigdl.llm.api.enabled)"})
                        return
                    ctx = rc.server_context(self.headers)
                    if ctx is not None:
                        self._trace = ctx.trace_id
                    with rc.activate(ctx):
                        router._api.handle_post(self, self.path)
                    return
                if self.path != "/worker_generate":
                    self._json(404, {"error": "unknown path"})
                    return
                ctx = rc.server_context(self.headers)
                if ctx is not None:
                    self._trace = ctx.trace_id
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n))
                    body["prompt_ids"] = [int(t)
                                          for t in body["prompt_ids"]]
                except Exception as e:  # noqa: BLE001
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                # the deadline is parsed ONCE; every backend call
                # re-derives the remaining budget from it (a relayed
                # original value would overstate the budget on any
                # retry or hedge)
                deadline = reliability.Deadline.from_header(
                    self.headers.get(reliability.DEADLINE_HEADER))
                # SLO class: relayed verbatim like the trace
                # headers — every backend attempt (including the
                # journal's failover resume on ANOTHER worker) carries
                # the submitter's class
                pri = self.headers.get(PRIORITY_HEADER)

                def fwd_headers():
                    hdrs = list(rc.to_headers(ctx))
                    if deadline is not None:
                        hdrs.append((reliability.DEADLINE_HEADER,
                                     deadline.to_header()))
                    if pri is not None:
                        hdrs.append((PRIORITY_HEADER, pri))
                    return hdrs

                with rc.activate(ctx), \
                        obs.span("llm/route", stage="llm_router",
                                 tokens=len(body["prompt_ids"])):
                    if router._active:
                        router._route_failover(self, body, fwd_headers,
                                               deadline, priority=pri)
                    else:
                        router._route(self, body, fwd_headers)

        self._httpd = _QuietHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address
        self._thread = None

    # -- journal/prober views ------------------------------------------------
    @property
    def failovers(self) -> int:
        return self._journal.failovers if self._journal else 0

    @property
    def tokens_resumed(self) -> int:
        return self._journal.tokens_resumed if self._journal else 0

    @property
    def hedges_issued(self) -> int:
        return self._hedge.hedges if self._hedge else 0

    def _prober_targets(self):
        with self._pool_lock:
            return ([(a, "prefill") for a in self.prefill_workers]
                    + [(a, "decode") for a in self.decode_workers])

    def _federation_targets(self):
        """Live pool membership for the fleet collector:
        one member per distinct backend address — a worker in both
        pools is scraped once."""
        with self._pool_lock:
            seen = {}
            for a in self.prefill_workers + self.decode_workers:
                seen.setdefault(f"{a[0]}:{a[1]}", a)
        return sorted(seen.items())

    def _on_probe(self, addr, role, healthy, body):
        ins = self._instruments()
        if ins is not None and "healthy" in ins:
            ins["healthy"].labels(
                backend=f"{addr[0]}:{addr[1]}", role=role).set(
                    1 if healthy else 0)

    # -- metrics -------------------------------------------------------------
    def _instruments(self):
        if not obs.enabled():
            return None
        if self._ins is None:
            ins = {
                "breaker_state": obs.gauge(
                    "bigdl_router_breaker_state",
                    "Per-backend circuit-breaker state "
                    "(0=closed, 1=half_open, 2=open)",
                    labelnames=("backend",)),
            }
            if self._active:
                ins.update({
                    "failovers": obs.counter(
                        "bigdl_router_failovers_total",
                        "Requests re-dispatched to another backend "
                        "after a failure", labelnames=("stage",)),
                    "hedges": obs.counter(
                        "bigdl_router_hedges_total",
                        "Hedged backend calls by outcome",
                        labelnames=("stage", "outcome")),
                    "journal": obs.gauge(
                        "bigdl_router_journal_inflight",
                        "Routed requests currently in the failover "
                        "journal"),
                    "healthy": obs.gauge(
                        "bigdl_router_backend_healthy",
                        "Prober verdict per backend (1 healthy)",
                        labelnames=("backend", "role")),
                })
            self._ins = ins
        return self._ins

    def _record_breakers(self):
        ins = self._instruments()
        if ins is None:
            return
        with self._pool_lock:
            items = list(self._breakers.items())
        for addr, b in items:
            ins["breaker_state"].labels(
                backend=f"{addr[0]}:{addr[1]}").set(
                    BREAKER_STATE_VALUES.get(b.state, 2))

    # -- surfaces ------------------------------------------------------------
    def _healthz(self):
        ok, report = reliability.health_report()
        with self._pool_lock:
            states = {f"{a[0]}:{a[1]}": self._breakers[a].state
                      for a in self._breakers}
            decode_up = any(
                self._breakers[a].state != "open"
                and (self._prober is None or self._prober.healthy(a))
                for a in self.decode_workers)
        self._record_breakers()
        healthy = ok and decode_up
        body = {
            "status": "ok" if healthy else "unhealthy",
            "role": "router",
            "backends": states,
            "checks": report}
        if self._active:
            body["journal_inflight"] = self._journal.inflight()
            body["failovers"] = self.failovers
            body["hedges_issued"] = self.hedges_issued
        if self._prober is not None:
            body["prober"] = self._prober.status()
            # drain-aware verdicts: "draining" is visibly
            # distinct from "dead"/"stalled" in the fleet view
            body["backend_states"] = self._prober.states()
        if self._fleet is not None:
            body["fleet"] = {"workers": len(self.decode_workers),
                             "scale_outs": self._fleet.scale_outs,
                             "scale_ins": self._fleet.scale_ins}
        if self._slo is not None:
            # rolling burn rate: one number an autoscaler
            # or alert reads instead of differencing counters
            body["slo"] = self._slo.status()
        return (200 if healthy else 503), body

    def _status_body(self):
        with self._pool_lock:
            body = {
                "role": "router",
                "prefill_workers": len(self.prefill_workers),
                "decode_workers": len(self.decode_workers),
                "requests_routed": self.requests_routed,
                "handoffs_routed": self.handoffs_routed,
                "prefill_degraded": self.prefill_degraded}
            if self._active:
                body.update({
                    "prefill_pool": [f"{a[0]}:{a[1]}"
                                     for a in self.prefill_workers],
                    "decode_pool": [f"{a[0]}:{a[1]}"
                                    for a in self.decode_workers],
                    "failover_enabled": self.failover_enabled,
                    "journal_inflight": self._journal.inflight(),
                    "journal": self._journal.snapshot(),
                    "failovers": self.failovers,
                    "tokens_resumed": self.tokens_resumed,
                    "hedges_issued": self.hedges_issued})
        return body

    def _admin_backends(self, body: dict):
        """``POST /backends``: join/leave pool members without a
        restart. {"action": "add"|"remove", "role": "prefill"|"decode",
        "host": ..., "port": ...}"""
        action = body.get("action")
        role = body.get("role")
        if action not in ("add", "remove") or \
                role not in ("prefill", "decode"):
            raise ValueError("need action add|remove and role "
                             "prefill|decode")
        addr = (str(body["host"]), int(body["port"]))
        with self._pool_lock:
            pool = (self.prefill_workers if role == "prefill"
                    else self.decode_workers)
            if action == "add":
                if addr not in pool:
                    pool.append(addr)
                    self._breaker_for(addr)
            else:
                if role == "decode" and len(pool) == 1 \
                        and addr in pool:
                    raise ValueError("refusing to remove the last "
                                     "decode backend")
                if addr in pool:
                    pool.remove(addr)
                other = (self.decode_workers if role == "prefill"
                         else self.prefill_workers)
                if addr not in other:
                    self._breakers.pop(addr, None)
                if self._prober is not None:
                    self._prober.forget(addr)
            out = {"prefill_workers": [list(a) for a in
                                       self.prefill_workers],
                   "decode_workers": [list(a) for a in
                                      self.decode_workers]}
        return 200, out

    # -- placement -----------------------------------------------------------
    def _pick(self, kind: str, exclude=frozenset()
              ) -> Optional[Tuple[str, int]]:
        """Round-robin over the pool, skipping open breakers (the
        half-open probe slot is granted like any call) and — with the
        prober running — backends whose last ``/healthz`` failed.
        ``exclude`` softly avoids backends that already failed this
        request: if excluding them empties the pool, they are retried
        rather than failing the request outright."""
        with self._pool_lock:
            pool = list(self.prefill_workers if kind == "prefill"
                        else self.decode_workers)
            if not pool:
                return None
            for skip_excluded in (True, False) if exclude else (False,):
                for off in range(len(pool)):
                    addr = pool[(self._rr[kind] + off) % len(pool)]
                    if skip_excluded and addr in exclude:
                        continue
                    if not self._breakers[addr].allow():
                        continue
                    if self._prober is not None and \
                            not self._prober.healthy(addr):
                        continue
                    self._rr[kind] = \
                        (self._rr[kind] + off + 1) % len(pool)
                    return addr
        return None

    def _breaker_for(self, addr):
        with self._pool_lock:
            b = self._breakers.get(addr)
            if b is None:
                b = self._breakers[addr] = reliability.CircuitBreaker(
                    f"llm_router:{addr[0]}:{addr[1]}",
                    failure_threshold=self._breaker_threshold,
                    reset_timeout=self._breaker_reset)
            return b

    def _call(self, addr, path, body, headers, canceller=None):
        """Backend call under its breaker; raises on transport errors
        and 5xx so the breaker sees them. A 503 shed is NOT a failure:
        the backend is alive and applying backpressure — it is relayed
        to the caller (with its own Retry-After, unchanged) instead of
        tripping the breaker, else transient overload on a healthy
        worker would escalate to the whole backend being circuit-broken
        out."""
        breaker = self._breaker_for(addr)
        try:
            reliability.inject("router.dispatch")
            status, parsed, hdrs = _post_json(
                addr, path, body, headers, self.request_timeout,
                canceller=canceller)
        except Exception:
            # a cancelled hedge loser died because WE closed its
            # socket, not because the backend failed — recording it
            # would circuit-break the consistently-slower (but
            # healthy) twin out of the pool
            if canceller is None or not canceller.cancelled:
                breaker.record_failure()
                self._record_breakers()
            raise
        if status >= 500 and status != 503:
            breaker.record_failure()
            self._record_breakers()
            raise RuntimeError(
                f"{addr[0]}:{addr[1]}{path} answered {status}: "
                f"{parsed.get('error', '')}")
        breaker.record_success()
        return status, parsed, hdrs

    # -- blocking routing: failover + hedging disabled -----------------------
    def _route(self, handler, body, fwd_headers):
        prompt_ids = body["prompt_ids"]
        # stage 1: prefill + export (optional — losing it only costs
        # the decode worker a full prefill)
        handoff = None
        addr = self._pick("prefill")
        if addr is not None:
            try:
                status, parsed, _ = self._call(
                    addr, "/worker_prefill",
                    {"prompt_ids": prompt_ids}, fwd_headers())
                if status == 200:
                    handoff = parsed.get("handoff")
            except Exception:
                pass
        if handoff is None and self.prefill_workers:
            self.prefill_degraded += 1
        # stage 2: import + decode
        addr = self._pick("decode")
        if addr is None:
            reliability.count_shed("llm_router")
            handler._json(503, {"error": "no decode backend available "
                                "(breakers open)"},
                          headers=(("Retry-After",
                                    reliability.retry_after_seconds(0)),))
            return
        try:
            if handoff:
                try:
                    self._call(addr, "/worker_import_chain",
                               {"handoff": handoff}, fwd_headers())
                    self.handoffs_routed += 1
                except Exception:
                    pass   # decode still works, just re-prefills
            status, parsed, hdrs = self._call(addr, "/worker_generate",
                                              body, fwd_headers())
        except Exception as e:  # noqa: BLE001
            handler._json(502, {"error": f"decode backend failed: {e}"})
            return
        if status == 503:
            reliability.count_shed("llm_router")
            # the backend's own Retry-After rides through unchanged
            #
            ra = hdrs.get("Retry-After") or \
                reliability.retry_after_seconds(0)
            handler._json(503, parsed, headers=(("Retry-After", ra),))
            return
        self.requests_routed += 1
        handler._json(status, parsed)

    # -- failover routing ------------------------------------------
    def _prefill_stage(self, prompt_ids, fwd_headers):
        """Hedged, best-effort prefill+export: returns the handoff blob
        or None (the decode backend then prefills itself)."""
        from bigdl_tpu_torch.llm import failover as fo
        addr = self._pick("prefill")
        if addr is None:
            return None

        def attempt(a):
            def run(canceller):
                status, parsed, _ = self._call(
                    a, "/worker_prefill", {"prompt_ids": prompt_ids},
                    fwd_headers(), canceller=canceller)
                if status != 200:
                    raise RuntimeError(
                        f"prefill backend answered {status}")
                return parsed.get("handoff")
            return run

        hedge_fn = None
        hedge_addr = None
        if self._hedge.allow():
            hedge_addr = self._pick("prefill", exclude={addr})
            if hedge_addr is not None and hedge_addr != addr:
                hedge_fn = attempt(hedge_addr)
        delay = self._hedge.delay_for(self._latency["prefill"])
        t0 = time.perf_counter()

        def on_hedge():
            self._hedge.note_hedge()
            flight.record("hedge", stage="prefill",
                          backend=f"{hedge_addr[0]}:{hedge_addr[1]}")
            ins = self._instruments()
            if ins is not None and "hedges" in ins:
                ins["hedges"].labels(stage="prefill",
                                     outcome="issued").inc()

        try:
            blob, outcome = fo.run_hedged(attempt(addr), hedge_fn,
                                          delay, on_hedge)
        except Exception:
            return None
        self._latency["prefill"].record(time.perf_counter() - t0)
        if outcome != "primary":
            self._note_hedge_outcome("prefill", outcome)
        return blob

    def _note_hedge_outcome(self, stage, outcome):
        ins = self._instruments()
        if ins is not None and "hedges" in ins:
            ins["hedges"].labels(stage=stage, outcome=outcome).inc()

    def _stream_decode(self, addr, body, headers, canceller, on_tokens):
        """One decode attempt over ``/worker_generate_stream``: every
        chunk's cumulative token list feeds ``on_tokens`` (the journal
        update — tokens survive the attempt failing). Returns the
        finish reason. Raises :class:`_BackendShed` (503),
        :class:`_BackendFatal` (other 4xx) or a failover-eligible error
        (transport / 5xx / mid-generation engine failure — the breaker
        records those). A :class:`~bigdl_tpu_torch.llm.failover.StreamAbort`
        raised out of ``on_tokens`` (the SSE relay tearing the stream
        down) propagates without blaming the breaker — the
        backend did nothing wrong."""
        from bigdl_tpu_torch.llm import failover as fo
        breaker = self._breaker_for(addr)
        conn = http.client.HTTPConnection(addr[0], addr[1],
                                          timeout=self.request_timeout)
        if canceller is not None:
            canceller.attach(conn)
        try:
            try:
                reliability.inject("router.dispatch")
                hdrs = {"Content-Type": "application/json"}
                for k, v in headers:
                    hdrs[k] = v
                conn.request("POST", "/worker_generate_stream",
                             json.dumps(body), hdrs)
                resp = conn.getresponse()
                if resp.status != 200:
                    data = resp.read()
                    try:
                        parsed = json.loads(data.decode())
                    except ValueError:
                        parsed = {"error":
                                  data.decode(errors="replace")[:200]}
                    if resp.status == 503:
                        breaker.record_success()
                        if parsed.get("draining"):
                            # drain shed: alive, no new
                            # work — re-route, don't relay, and never
                            # a breaker failure (regression-tested)
                            raise _BackendDraining(parsed)
                        raise _BackendShed(
                            parsed, resp.getheader("Retry-After"))
                    if resp.status >= 500:
                        raise RuntimeError(
                            f"{addr[0]}:{addr[1]} answered "
                            f"{resp.status}: {parsed.get('error', '')}")
                    breaker.record_success()
                    raise _BackendFatal(resp.status, parsed)
                last = None
                while True:
                    # mid-stream fault site: a raise here is a torn
                    # connection AFTER tokens drained — exactly the
                    # suffix-resume case the journal exists for
                    reliability.inject("router.dispatch")
                    line = resp.readline()
                    if not line:
                        break
                    line = line.strip()
                    if not line:
                        continue
                    obj = json.loads(line.decode())
                    on_tokens(obj.get("output_ids", []))
                    last = obj
                    if obj.get("done"):
                        break
                if last is None or not last.get("done"):
                    raise RuntimeError(
                        f"{addr[0]}:{addr[1]} stream ended before "
                        "done:true")
                if last.get("error"):
                    raise RuntimeError(
                        f"{addr[0]}:{addr[1]} failed mid-generation: "
                        f"{last['error']}")
                if last.get("finish_reason") == "timeout":
                    # the worker's stream wait expired with the request
                    # still parked on a wedged engine (watchdog off, or
                    # the request raced in after the trip sweep) — a
                    # silent truncation, not an answer. Retriable: the
                    # journal resumes the drained tokens elsewhere.
                    raise RuntimeError(
                        f"{addr[0]}:{addr[1]} timed out mid-generation "
                        f"({len(last.get('output_ids', []))} tokens "
                        "drained)")
            except (_BackendShed, _BackendFatal, _BackendDraining,
                    fo.StreamAbort):
                raise
            except Exception:
                # same hedge-loser carve-out as _call: a socket we
                # cancelled is not a backend failure
                if canceller is None or not canceller.cancelled:
                    breaker.record_failure()
                    self._record_breakers()
                raise
            breaker.record_success()
            return last.get("finish_reason") or "length"
        finally:
            conn.close()

    def _decode_attempt(self, addr, ent, fwd_headers, tried=None):
        """One (possibly hedged) decode dispatch resuming from the
        journal entry's current state. Tokens land in the entry AS THEY
        DRAIN; hedge twins run the same greedy resume so the longest
        cumulative list is always a consistent prefix of the answer.
        A launched hedge twin is added to ``tried`` so that when BOTH
        attempts fail, the failover loop excludes it too instead of
        burning the next attempt re-picking a known-bad backend."""
        from bigdl_tpu_torch.llm import failover as fo
        body = {"prompt_ids": ent.resume_prompt(),
                "max_new_tokens": ent.remaining}
        base = len(ent.tokens)
        lock = threading.Lock()

        def absorb(cur):
            with lock:
                ent.drained(cur, base)

        def attempt(a):
            def run(canceller):
                return self._stream_decode(a, body, fwd_headers(),
                                           canceller, absorb)
            return run

        hedge_fn = None
        hedge_addr = None
        # SSE-relayed requests never hedge: the drain listener fires
        # from whichever twin extends the journal, and a StreamAbort it
        # raises must unwind ONE attempt, not a race of two
        if self._hedge.allow() and ent.listener is None:
            hedge_addr = self._pick(
                "decode", exclude={addr} | (tried or set()))
            if hedge_addr is not None and hedge_addr != addr:
                hedge_fn = attempt(hedge_addr)
        delay = self._hedge.delay_for(self._latency["decode"])

        def on_hedge():
            self._hedge.note_hedge()
            ent.hedges += 1
            flight.record("hedge", stage="decode", entry=ent.id,
                          backend=f"{hedge_addr[0]}:{hedge_addr[1]}")
            if tried is not None:
                tried.add(hedge_addr)
            ins = self._instruments()
            if ins is not None and "hedges" in ins:
                ins["hedges"].labels(stage="decode",
                                     outcome="issued").inc()

        t0 = time.perf_counter()
        if hedge_fn is not None:
            with obs.span("router/hedge", stage="llm_router",
                          backend=f"{addr[0]}:{addr[1]}"):
                # prefer= keeps a backend's 4xx/shed verdict from
                # being masked by the twin's later transport error —
                # those must relay, not burn failover attempts
                reason, outcome = fo.run_hedged(
                    attempt(addr), hedge_fn, delay, on_hedge,
                    prefer=(_BackendShed, _BackendFatal,
                            _BackendDraining))
        else:
            reason, outcome = fo.run_hedged(attempt(addr), None, delay)
        self._latency["decode"].record(time.perf_counter() - t0)
        if outcome != "primary":
            self._note_hedge_outcome("decode", outcome)
        return reason

    def _route_failover(self, handler, body, fwd_headers, deadline,
                        priority=None):
        """The native JSON surface over :meth:`_dispatch_failover`:
        typed routing errors render through ``handler._json``."""
        try:
            ent = self._dispatch_failover(body, fwd_headers, deadline,
                                          priority=priority)
        except _RouteError as e:
            handler._json(e.status, e.body, headers=e.headers)
            return
        handler._json(200, {
            "output_ids": [int(t) for t in ent.tokens],
            "finish_reason": ent.finish_reason or "length"})

    def _observe_slo(self, ent):
        """Client-visible SLO verdict from the journal's token arrival
        stamps: resumed/hedged tokens were stamped exactly
        once by ``JournalEntry.drained``, so a mid-stream failover
        contributes its recovery gap as ONE inter-token sample instead
        of replayed duplicates. Shared by the native JSON path and the
        OpenAI SSE relay — the gateway's chunks fire from
        the same drain events, so there is one accounting, not two."""
        if self._slo is None:
            return
        from bigdl_tpu_torch.observability.slo import itl_samples
        times = list(ent.token_times)
        if times:
            ttft = times[0] - ent.created_at
            self._slo.observe_ttft(ttft)
            gaps = itl_samples(times)
            for g in gaps:
                self._slo.observe_itl(g)
            self._slo.finish(ttft, max(gaps) if gaps else None)
        else:
            self._slo.finish(None, None)

    def _dispatch_failover(self, body, fwd_headers, deadline,
                           priority=None, listener=None):
        """Journal + resume dispatch loop, decoupled from the
        HTTP handler: returns the completed journal entry or
        raises :class:`_RouteError`. ``listener`` (the OpenAI gateway's
        per-delta callback) is installed as the entry's drain listener;
        a :class:`~bigdl_tpu_torch.llm.failover.StreamAbort` it raises tears
        down the attempt without a failover retry and propagates after
        the delivered tokens are SLO-observed."""
        from bigdl_tpu_torch.llm import failover as fo
        prompt_ids = body["prompt_ids"]
        try:
            mnt = int(body.get("max_new_tokens", 32))
        except (TypeError, ValueError):
            raise _RouteError(400, {"error": "bad max_new_tokens"})
        ent = self._journal.add(prompt_ids, mnt, priority=priority)
        ent.listener = listener
        self._hedge.note_request()
        ins = self._instruments()
        if ins is not None and "journal" in ins:
            ins["journal"].set(self._journal.inflight())
        try:
            handoff = self._prefill_stage(prompt_ids, fwd_headers)
            if handoff is None and self.prefill_workers:
                self.prefill_degraded += 1
            imported = set()
            tried = set()
            drain_bounces = 0
            while True:
                if deadline is not None and deadline.expired():
                    raise _RouteError(504, {
                        "error": "deadline exceeded while routing",
                        "tokens_drained": len(ent.tokens)})
                addr = self._pick("decode", exclude=tried)
                if addr is None:
                    reliability.count_shed("llm_router")
                    raise _RouteError(
                        503, {"error": "no decode backend available "
                              "(breakers open or unhealthy)"},
                        headers=(("Retry-After",
                                  reliability.retry_after_seconds(
                                      self._journal.inflight())),))
                if handoff and addr not in imported:
                    try:
                        self._call(addr, "/worker_import_chain",
                                   {"handoff": handoff}, fwd_headers())
                        self.handoffs_routed += 1
                    except Exception:
                        pass   # decode still works, just re-prefills
                    imported.add(addr)
                ent.attempts += 1
                try:
                    ent.finish_reason = self._decode_attempt(
                        addr, ent, fwd_headers, tried)
                    break
                except fo.StreamAbort:
                    # the SSE relay tore the stream down (client gone,
                    # or stop satisfied): no retry, no breaker blame —
                    # observe what was delivered, let the gateway
                    # decide how the request ends
                    self._observe_slo(ent)
                    raise
                except _BackendDraining:
                    # drain bounce: the backend is healthy
                    # but winding down — route elsewhere without
                    # consuming a failover attempt or tripping
                    # anything. The prober mark makes _pick skip it
                    # outright from here on (a fully-draining pool then
                    # sheds through the addr-is-None arm above).
                    ent.attempts -= 1
                    tried.add(addr)
                    if self._prober is not None:
                        self._prober.mark(addr, "draining")
                    drain_bounces = drain_bounces + 1
                    if drain_bounces > 2 * max(
                            len(self.decode_workers), 1):
                        reliability.count_shed("llm_router")
                        raise _RouteError(
                            503, {"error": "every decode backend is "
                                  "draining"},
                            headers=(("Retry-After",
                                      reliability.retry_after_seconds(
                                          self._journal.inflight())),))
                    continue
                except _BackendShed as e:
                    reliability.count_shed("llm_router")
                    ra = e.retry_after or \
                        reliability.retry_after_seconds(0)
                    raise _RouteError(503, e.parsed,
                                      headers=(("Retry-After", ra),))
                except _BackendFatal as e:
                    raise _RouteError(e.status, e.parsed)
                except Exception as e:  # noqa: BLE001 — failover
                    tried.add(addr)
                    if ent.remaining == 0:
                        # the connection died delivering the final
                        # token: the budget is already fulfilled
                        ent.finish_reason = ent.finish_reason or "length"
                        break
                    if not self.failover_enabled or \
                            ent.attempts >= self.max_attempts:
                        raise _RouteError(502, {
                            "error": f"decode backend failed after "
                                     f"{ent.attempts} attempt(s): {e}",
                            "tokens_drained": len(ent.tokens)})
                    # journal → resume: re-dispatch prompt + generated
                    # so far to another backend
                    self._journal.record_failover(ent)
                    if ins is not None and "failovers" in ins:
                        ins["failovers"].labels(stage="decode").inc()
                    obs.add_complete(
                        "router/failover", time.time(), 0.0,
                        stage="llm_router",
                        backend=f"{addr[0]}:{addr[1]}",
                        tokens_resumed=len(ent.tokens),
                        attempt=ent.attempts,
                        **({"trace": rc.current().trace_id}
                           if rc.current() is not None else {}))
                    continue
            self.requests_routed += 1
            self._observe_slo(ent)
            return ent
        finally:
            self._journal.complete(ent)
            if ins is not None and "journal" in ins:
                ins["journal"].set(self._journal.inflight())

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "LLMRouter":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        if self._prober is not None and self._start_prober:
            self._prober.start()
        if self._collector is not None:
            self._collector.start()
        # time-series plane: the router's store rides the
        # federation collector's scrape cache when there is one
        self._timeseries = timeseries.acquire()
        if self._timeseries is not None and self._collector is not None:
            timeseries.attach_collector(self._collector)
        if self._fleet is not None and self._start_fleet:
            self._fleet.start()
        return self

    def stop(self):
        # the fleet controller stops FIRST: it may hold an in-progress
        # drain, which must be cancelled before the prober/membership
        # surfaces it depends on go away
        if self._fleet is not None:
            self._fleet.stop()
        if getattr(self, "_timeseries", None) is not None:
            if self._collector is not None:
                timeseries.detach_collector(self._collector)
            timeseries.release()
            self._timeseries = None
        if self._collector is not None:
            self._collector.stop()
        if self._prober is not None:
            self._prober.stop()
        if self._thread is not None:
            # shutdown() handshakes with serve_forever — calling it on
            # a never-started router would wait forever
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        self._httpd.server_close()
