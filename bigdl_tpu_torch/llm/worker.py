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

Submission splits failures 422 (invalid request) / 503 + Retry-After
(the engine's ``OverloadError``: queue full, draining) / 500 (anything
else); ``X-BigDL-Deadline-Ms`` caps the wait; the generate endpoints
read and echo ``X-BigDL-Trace-Id`` so the engine's spans stitch under
the caller's trace.

Handler threads stay on the host: they pass numpy ids to ``submit`` and
read host state only (the engine thread alone runs device work under
``torch.inference_mode``).

Not ported yet (ROADMAP Queue 1 item 8): ``LLMRouter``, the fleet's
drain coordinator (``/worker_drain``), metric federation
(``/metrics/snapshot``) and the time-series plane (``/metrics/query``,
``/fleet/timeline``, ``/alerts``). Their endpoints answer the JAX
worker's 404s while their switches are off, which is the default;
turning one on raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import base64
import sys
import json
import threading
import time
from urllib.parse import urlsplit
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.observability import flight
from bigdl_tpu_torch.observability import request_context as rc
from bigdl_tpu_torch.observability import tracing

ROLES = ("", "prefill", "decode")

# the time-series plane's endpoints, answered with the JAX worker's 404
# (the plane is not ported)
_TIMESERIES_PATHS = ("/metrics/query", "/fleet/timeline", "/alerts")

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
        # planes the port has not ported: off (the default) they answer
        # the JAX worker's 404s; asked for, they raise
        if (federation if federation is not None else
                conf.get_bool("bigdl.observability.federation", False)):
            raise NotImplementedError(
                "federation=True: metric federation (/metrics/snapshot) "
                "is not ported yet (ROADMAP Queue 1 item 8)")
        if (fleet if fleet is not None else
                conf.get_bool("bigdl.llm.fleet.enabled", False)):
            raise NotImplementedError(
                "fleet=True: the drain coordinator (/worker_drain) is not "
                "ported yet (ROADMAP Queue 1 item 8)")
        obs.require_unported_off()
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
                if debug is not None:
                    self._json(*debug)
                elif urlsplit(self.path).path in _TIMESERIES_PATHS:
                    self._json(404, {
                        "error": "timeseries disabled",
                        "gate": "bigdl.observability.timeseries.enabled"})
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
                    self._json(404, {"error": "fleet disabled"})
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
                    self._json(404, {"error": "federation disabled"})
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
                    self._json(404, {"error": "fleet disabled"})
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
        return self

    def stop(self):
        if self._thread is not None:
            # shutdown() handshakes with serve_forever — calling it on
            # a never-started server would wait forever
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        self._httpd.server_close()


