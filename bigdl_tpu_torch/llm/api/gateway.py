"""OpenAI-compatible serving gateway — the port of
``bigdl_tpu/llm/api/gateway.py``.

The stack's native surface is bespoke (``/worker_generate*``, token
arrays, JSON-lines streaming). This module puts the ecosystem surface
in front of it — ``POST /v1/completions``, ``POST /v1/chat/completions``
and ``GET /v1/models``, the schema subset fastchat/langchain/OpenAI
clients already speak — **without a second serving path**: the gateway
is a translator over the same engine submit / failover dispatch the
native endpoints use, so SLO accounting, shed policy, failover
bit-parity and priority classes all come along for free.

Layering:

- :class:`OpenAIGateway` — schema translation + SSE relay + error
  mapping + the ``bigdl_api_requests_total{route,outcome}`` counter and
  the ``api/request`` span. One instance per surface, constructed ONLY
  when ``bigdl.llm.api.enabled`` (``LLMWorker``/``LLMRouter`` own the
  gate; off means /v1/* 404s and none of this exists).
- A *backend* adapter carries dispatch: :class:`EngineBackend` drains
  an in-process :class:`~bigdl_tpu_torch.llm.serving.LLMServer` request
  (single-node worker), while the router passes its own adapter over
  the failover journal — there the per-token SSE relay IS the journal
  drain listener, so a mid-stream failover is invisible to the client
  and every token is stamped exactly once for the router SLO sketches
  (one accounting, not two).

Streaming contract (``stream=true``): one ``data:`` chunk per drained
token group, ``usage`` on the final chunk, ``data: [DONE]`` terminal.
A client disconnect surfaces as :class:`~bigdl_tpu_torch.llm.failover.
StreamAbort` from the socket write and aborts the engine request via
the existing ``LLMServer.abort`` path — slot and KV pages free instead
of decoding tokens nobody will read.

Sampling is **server-configured** in this engine (``LLMServer(
temperature=, top_k=)`` — greedy by default, and the failover/parity
contracts depend on determinism). The gateway therefore validates
``temperature``/``top_k``/``top_p`` against the backend's configuration
instead of silently ignoring them: omit them, or match the server.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import List, Optional, Sequence

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.llm.api.errors import (ApiError, InvalidRequestError,
                                            RateLimitError, UpstreamError)
from bigdl_tpu_torch.llm.api.sse import SSEWriter
from bigdl_tpu_torch.llm.api.templates import (apply_chat_template,
                                               build_tokenizer)
from bigdl_tpu_torch.llm.failover import StreamAbort
from bigdl_tpu_torch.observability import flight

#: mirrors worker.PRIORITY_HEADER / serving.PRIORITY_CLASSES without
#: importing the engine stack into the translation layer (the worker
#: module imports *this* package lazily from its gated ctor)
PRIORITY_HEADER = "X-BigDL-Priority"
PRIORITY_CLASSES = ("interactive", "standard", "batch")

GET_ROUTES = ("/v1/models",)
POST_ROUTES = ("/v1/completions", "/v1/chat/completions")


def _find(buf, pat) -> int:
    """``buf.find(pat)`` generalized to token-id lists."""
    if isinstance(buf, str):
        return buf.find(pat)
    n, m = len(buf), len(pat)
    for i in range(n - m + 1):
        if buf[i:i + m] == pat:
            return i
    return -1


class StopMatcher:
    """Incremental ``stop``-sequence matcher over a stream of pieces
    (text or token-id lists — the sequence type just has to slice and
    compare). :meth:`feed` returns the longest prefix that is safe to
    emit: anything that could still grow into a stop sequence is held
    back, so a stop split across two drained chunks is still cut
    exactly at the match, never leaked to the client."""

    def __init__(self, stops: Sequence):
        self.stops = list(stops)
        self.buf = None        # lazily typed from the first piece
        self.hit = False

    def feed(self, piece):
        """-> (emit, done). ``done`` means a stop matched; ``emit`` is
        everything up to (excluding) the match."""
        if not self.stops:
            return piece, False
        self.buf = piece if self.buf is None else self.buf + piece
        best = -1
        for s in self.stops:
            idx = _find(self.buf, s)
            if idx >= 0 and (best < 0 or idx < best):
                best = idx
        if best >= 0:
            emit = self.buf[:best]
            self.buf = self.buf[:0]
            self.hit = True
            return emit, True
        hold = 0
        for s in self.stops:
            top = min(len(s) - 1, len(self.buf))
            for k in range(top, hold, -1):
                if self.buf[len(self.buf) - k:] == s[:k]:
                    hold = k
                    break
        cut = len(self.buf) - hold
        emit = self.buf[:cut]
        self.buf = self.buf[cut:]
        return emit, False

    def flush(self):
        """Held-back remainder once the stream ends without a match."""
        if self.buf is None or self.hit:
            return None
        out, self.buf = self.buf, self.buf[:0]
        return out if len(out) else None


class TranslatedRequest:
    """The OpenAI request body mapped onto engine terms."""

    __slots__ = ("rid", "created", "chat", "prompt_ids", "max_tokens",
                 "n", "stream", "stops_text", "stops_tokens",
                 "priority", "deadline")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


class EngineBackend:
    """Direct-engine dispatch for the single-node worker surface: the
    same submit / drain-loop / EOS-terminal / abort discipline as the
    native ``/worker_generate_stream`` handler, surfaced through the
    gateway's exception vocabulary."""

    def __init__(self, server, model_name: str,
                 request_timeout: float = 600.0):
        self.server = server
        self.model_name = model_name
        self.request_timeout = request_timeout

    def sampling(self):
        return (float(getattr(self.server, "temperature", 0.0) or 0.0),
                int(getattr(self.server, "top_k", 0) or 0))

    def _retry_after(self, priority) -> str:
        # class-weighted queue depth, same
        # derivation as the native 503 path
        rd = getattr(self.server, "retry_depth", None)
        if rd is not None:
            depth = rd(priority)
        else:
            q = getattr(self.server, "_queue", None)
            depth = q.qsize() if q is not None else 0
        return reliability.retry_after_seconds(depth)

    def generate(self, prompt_ids: List[int], max_new_tokens: int,
                 priority: Optional[str], deadline,
                 on_delta) -> tuple:
        import numpy as np
        ids = np.asarray(prompt_ids, np.int32)
        kw = {"priority": priority} if priority is not None else {}
        try:
            req = self.server.submit(ids, max_new_tokens=max_new_tokens,
                                     **kw)
        except reliability.OverloadError as e:
            raise RateLimitError(str(e),
                                 retry_after=self._retry_after(priority))
        except ValueError as e:
            raise InvalidRequestError(str(e), status=422)
        timeout = self.request_timeout if deadline is None else \
            max(min(self.request_timeout, deadline.remaining()), 0.0)
        end = time.time() + timeout
        abort = getattr(self.server, "abort", None)
        seen: List[int] = []
        try:
            while True:
                done = req.done.wait(0.02)
                cur = list(req.tokens)
                eos = self.server.eos_token_id
                if not done and req.error is None and eos is not None \
                        and cur and cur[-1] == eos:
                    # EOS-chunk-is-terminal, same rule as the native
                    # stream: never hand a resumable view that a
                    # failover could extend past EOS
                    done = True
                if len(cur) > len(seen):
                    new = cur[len(seen):]
                    seen[:] = cur
                    if on_delta is not None:
                        on_delta([int(t) for t in new])
                if done:
                    if req.error is not None:
                        raise UpstreamError(
                            f"engine failed: {req.error}", status=500)
                    finish = ("stop" if eos is not None and cur
                              and cur[-1] == eos else "length")
                    return [int(t) for t in seen], finish
                if time.time() >= end:
                    if abort is not None:
                        abort(req, reason="api request timed out")
                    raise UpstreamError("generation timed out",
                                        status=504)
        except StreamAbort as e:
            # client gone or stop satisfied: free the slot + KV pages
            # instead of decoding tokens nobody will read
            if abort is not None:
                abort(req, reason=str(e))
            raise


class OpenAIGateway:
    """Translate /v1/* requests onto a backend adapter and stream the
    answer back — see the module docstring for the contract."""

    def __init__(self, backend, tokenizer=None,
                 chat_family: Optional[str] = None,
                 scope: str = "worker"):
        from bigdl_tpu_torch.utils.conf import conf
        self.backend = backend
        self.tokenizer = (tokenizer if tokenizer is not None else
                          build_tokenizer(
                              conf.get("bigdl.llm.api.tokenizer", "")))
        self.chat_family = (chat_family or
                            conf.get("bigdl.llm.api.chat_template",
                                     "plain"))
        self.scope = scope
        self._requests = None     # lazy bigdl_api_requests_total

    # -- observability -------------------------------------------------------
    def _count(self, route: str, outcome: str):
        if not obs.enabled():
            return
        if self._requests is None:
            self._requests = obs.counter(
                "bigdl_api_requests_total",
                "OpenAI gateway requests by route and outcome",
                labelnames=("route", "outcome"))
        self._requests.labels(route=route, outcome=outcome).inc()

    # -- GET /v1/models ------------------------------------------------------
    def handle_models(self, handler):
        handler._json(200, {
            "object": "list",
            "data": [{"id": self.backend.model_name, "object": "model",
                      "created": int(time.time()),
                      "owned_by": "bigdl-tpu"}]})
        self._count("/v1/models", "ok")

    # -- POST /v1/completions + /v1/chat/completions -------------------------
    def handle_post(self, handler, path: str):
        chat = path == "/v1/chat/completions"
        writer = None
        rid = None
        try:
            with obs.span("api/request", stage="api_gateway",
                          route=path):
                try:
                    n = int(handler.headers.get("Content-Length", 0))
                    raw = handler.rfile.read(n) if n else b""
                    body = json.loads(raw) if raw else {}
                except ValueError as e:
                    raise InvalidRequestError(f"body is not JSON: {e}")
                if not isinstance(body, dict):
                    raise InvalidRequestError(
                        "body must be a JSON object")
                treq = self._translate(body, handler.headers, chat=chat)
                if treq.stream:
                    writer = SSEWriter(
                        handler, trace_id=getattr(handler, "_trace",
                                                  None))
                    rid = treq.rid
                    self._dispatch_stream(handler, treq, path, writer)
                else:
                    self._dispatch_blocking(handler, treq, path)
            self._count(path, "ok")
        except StreamAbort as e:
            if not e.client_gone:   # defensive: stop aborts are
                raise               # consumed inside _run_choice
            # flight event at the abort site: the journaled
            # request id ties the explain timeline to the disconnect
            flight.record("client_abort", request_id=rid, route=path,
                          scope=self.scope)
            self._count(path, "disconnect")
            handler.close_connection = True
        except ApiError as e:
            outcome = ("shed" if isinstance(e, RateLimitError) else
                       "invalid" if isinstance(e, InvalidRequestError)
                       else "error")
            if isinstance(e, RateLimitError):
                # flight event at the shed site, next to the 429
                flight.record("shed", request_id=rid, route=path,
                              scope=self.scope, source="api")
            self._count(path, outcome)
            if writer is not None and writer.started:
                # the 200 + SSE headers are on the wire: the error
                # travels as a terminal event, then [DONE]
                writer.event(e.body())
                writer.done()
            else:
                handler._json(e.status, e.body(), headers=e.headers())

    # -- translation ---------------------------------------------------------
    def _translate(self, body: dict, headers,
                   chat: bool) -> TranslatedRequest:
        model = body.get("model")
        if model is not None and model != self.backend.model_name:
            raise InvalidRequestError(
                f"model {model!r} not found (serving "
                f"{self.backend.model_name!r})", status=404,
                param="model", code="model_not_found")
        prompt_ids = self._prompt_ids(body, chat)
        try:
            max_tokens = int(body.get("max_tokens", 16))
        except (TypeError, ValueError):
            raise InvalidRequestError("max_tokens must be an integer",
                                      param="max_tokens")
        if max_tokens < 1:
            raise InvalidRequestError("max_tokens must be >= 1",
                                      param="max_tokens")
        try:
            n = int(body.get("n", 1))
        except (TypeError, ValueError):
            raise InvalidRequestError("n must be an integer", param="n")
        if not 1 <= n <= 8:
            raise InvalidRequestError("n must be in 1..8", param="n")
        self._check_sampling(body)
        stops_text, stops_tokens = self._stops(body.get("stop"))
        pri = headers.get(PRIORITY_HEADER)
        if pri is None:
            # OpenAI-style passthrough: a `user` field naming an SLO
            # class rides into the scheduler like the native header
            user = body.get("user")
            if isinstance(user, str) and user in PRIORITY_CLASSES:
                pri = user
        deadline = reliability.Deadline.from_header(
            headers.get(reliability.DEADLINE_HEADER))
        prefix = "chatcmpl" if chat else "cmpl"
        return TranslatedRequest(
            rid=f"{prefix}-{uuid.uuid4().hex[:24]}",
            created=int(time.time()), chat=chat, prompt_ids=prompt_ids,
            max_tokens=max_tokens, n=n,
            stream=bool(body.get("stream", False)),
            stops_text=stops_text, stops_tokens=stops_tokens,
            priority=pri, deadline=deadline)

    def _prompt_ids(self, body: dict, chat: bool) -> List[int]:
        if chat:
            text = apply_chat_template(self.chat_family,
                                       body.get("messages"))
            if self.tokenizer is None:
                raise InvalidRequestError(
                    "chat needs a tokenizer: set "
                    "bigdl.llm.api.tokenizer (no tokenizer assets ship "
                    "with this environment; 'byte' is the "
                    "deterministic test implementation)",
                    param="messages")
            return [int(t) for t in self.tokenizer.encode(text)]
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise InvalidRequestError(
                    "text prompts need a tokenizer: send a token-id "
                    "array, or set bigdl.llm.api.tokenizer",
                    param="prompt")
            return [int(t) for t in self.tokenizer.encode(prompt)]
        if isinstance(prompt, list) and prompt and \
                all(isinstance(t, int) and not isinstance(t, bool)
                    for t in prompt):
            return list(prompt)
        raise InvalidRequestError(
            "prompt must be a string or a non-empty token-id array",
            param="prompt")

    def _check_sampling(self, body: dict):
        """Reject sampling params that contradict the server-side
        config instead of silently ignoring them (see module doc)."""
        temp, top_k = self.backend.sampling()
        t = body.get("temperature")
        if t is not None and abs(float(t) - temp) > 1e-9:
            raise InvalidRequestError(
                f"sampling is server-configured (engine "
                f"temperature={temp}): omit temperature or match it",
                param="temperature")
        k = body.get("top_k")
        if k is not None and int(k) != top_k:
            raise InvalidRequestError(
                f"sampling is server-configured (engine top_k={top_k})"
                f": omit top_k or match it", param="top_k")
        p = body.get("top_p")
        if p is not None and abs(float(p) - 1.0) > 1e-9:
            raise InvalidRequestError(
                "top_p sampling is not supported (server-configured "
                "greedy/top-k engine): omit top_p or send 1.0",
                param="top_p")

    def _stops(self, stop):
        """Normalize OpenAI ``stop`` → (text stops, token stops)."""
        if stop is None:
            return [], []
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list) or not stop:
            raise InvalidRequestError(
                "stop must be a string, an array of strings, or an "
                "array of token-id arrays", param="stop")
        if all(isinstance(s, int) and not isinstance(s, bool)
               for s in stop):
            stop = [stop]          # one token-id sequence
        if all(isinstance(s, str) for s in stop):
            if len(stop) > 4:
                raise InvalidRequestError("at most 4 stop sequences",
                                          param="stop")
            if self.tokenizer is None:
                raise InvalidRequestError(
                    "string stop sequences need a tokenizer: send "
                    "token-id arrays, or set bigdl.llm.api.tokenizer",
                    param="stop")
            return list(stop), []
        if all(isinstance(s, list) and s and
               all(isinstance(t, int) and not isinstance(t, bool)
                   for t in s) for s in stop):
            if len(stop) > 4:
                raise InvalidRequestError("at most 4 stop sequences",
                                          param="stop")
            return [], [list(s) for s in stop]
        raise InvalidRequestError(
            "stop must be a string, an array of strings, or an "
            "array of token-id arrays", param="stop")

    # -- dispatch ------------------------------------------------------------
    def _run_choice(self, treq: TranslatedRequest, emit=None):
        """One engine generation: stop matching + incremental emission.
        ``emit(delta_ids, delta_text)`` fires once per drained token
        group (either side may be None depending on tokenizer/stop
        mode). Returns ``(tokens_generated, finish_reason)``."""
        text_mode = bool(treq.stops_text)
        matcher = StopMatcher(treq.stops_text if text_mode
                              else treq.stops_tokens)
        generated: List[int] = []

        def on_delta(new_ids):
            generated.extend(new_ids)
            if text_mode:
                piece = self.tokenizer.decode(new_ids)
                out, done = matcher.feed(piece)
                if emit is not None and out:
                    emit(None, out)
            else:
                out, done = matcher.feed(list(new_ids))
                if emit is not None and len(out):
                    txt = (self.tokenizer.decode(out)
                           if self.tokenizer is not None else None)
                    emit(list(out), txt)
            if done:
                raise StreamAbort("stop sequence matched")

        stream_needed = emit is not None or bool(
            treq.stops_text or treq.stops_tokens)
        try:
            toks, finish = self.backend.generate(
                treq.prompt_ids, treq.max_tokens, treq.priority,
                treq.deadline, on_delta if stream_needed else None)
            if not stream_needed:
                generated[:] = toks
        except StreamAbort as e:
            if e.client_gone:
                raise
            finish = "stop"
        if not matcher.hit:
            tail = matcher.flush()
            if emit is not None and tail is not None:
                if text_mode:
                    emit(None, tail)
                else:
                    txt = (self.tokenizer.decode(tail)
                           if self.tokenizer is not None else None)
                    emit(list(tail), txt)
        return generated, finish

    def _collect_choice(self, treq: TranslatedRequest, index: int):
        """Blocking variant: accumulate what streaming would emit."""
        ids: List[int] = []
        texts: List[str] = []

        def emit(delta_ids, delta_text):
            if delta_ids is not None:
                ids.extend(delta_ids)
            if delta_text is not None:
                texts.append(delta_text)

        generated, finish = self._run_choice(treq, emit)
        text_mode = bool(treq.stops_text)
        choice = {"index": index, "finish_reason": finish}
        if text_mode:
            choice["text"] = "".join(texts)
        else:
            choice["text"] = ("".join(texts)
                              if self.tokenizer is not None else "")
            choice["token_ids"] = ids
        return choice, len(generated)

    def _usage(self, treq: TranslatedRequest, completion: int) -> dict:
        return {"prompt_tokens": len(treq.prompt_ids),
                "completion_tokens": completion,
                "total_tokens": len(treq.prompt_ids) + completion}

    def _dispatch_blocking(self, handler, treq, path: str):
        choices = []
        completion = 0
        for i in range(treq.n):
            choice, ntok = self._collect_choice(treq, i)
            completion += ntok
            if treq.chat:
                choice["message"] = {"role": "assistant",
                                     "content": choice.pop("text")}
            choices.append(choice)
        handler._json(200, {
            "id": treq.rid,
            "object": "chat.completion" if treq.chat
                      else "text_completion",
            "created": treq.created,
            "model": self.backend.model_name,
            "choices": choices,
            "usage": self._usage(treq, completion)})

    def _dispatch_stream(self, handler, treq, path: str,
                         writer: SSEWriter):
        obj = ("chat.completion.chunk" if treq.chat
               else "text_completion")

        def chunk(choice):
            return {"id": treq.rid, "object": obj,
                    "created": treq.created,
                    "model": self.backend.model_name,
                    "choices": [choice]}

        completion = 0
        for i in range(treq.n):
            first = [True]

            def emit(delta_ids, delta_text, _i=i, _first=first):
                choice = {"index": _i, "finish_reason": None}
                if treq.chat:
                    delta = {"content": delta_text or ""}
                    if _first[0]:
                        delta["role"] = "assistant"
                        _first[0] = False
                    choice["delta"] = delta
                else:
                    choice["text"] = (delta_text if delta_text
                                      is not None else "")
                if delta_ids is not None:
                    choice["token_ids"] = list(delta_ids)
                writer.event(chunk(choice))

            generated, finish = self._run_choice(treq, emit)
            completion += len(generated)
            final = {"index": i, "finish_reason": finish}
            if treq.chat:
                final["delta"] = {}
            else:
                final["text"] = ""
            payload = chunk(final)
            if i == treq.n - 1:
                # usage rides the FINAL chunk (the tentpole contract)
                payload["usage"] = self._usage(treq, completion)
            writer.event(payload)
        writer.done()
