"""Server-Sent Events framing for the OpenAI gateway — the port of
``bigdl_tpu/llm/api/sse.py``.

One chunk grammar, shared by the server side (the gateway's writer over
a chunked HTTP/1.1 response) and the client side (load generators,
tests)::

    data: {json}\\n\\n      # one event per drained token group
    data: [DONE]\\n\\n      # terminal sentinel, always last

The writer frames each event as its own HTTP chunk and flushes — the
relay from the engine's drain to the client socket is
per-token-group, never buffered to the end. A client that went away
surfaces as :class:`StreamAbort` (``client_gone=True``) from
:meth:`SSEWriter.event`, which the dispatch layer turns into the
existing abort path (engine slot + KV pages freed).
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

from bigdl_tpu_torch.llm.failover import StreamAbort

#: terminal sentinel line, exactly as OpenAI emits it
DONE = "[DONE]"


def sse_event(obj) -> bytes:
    """One SSE event: ``data: {json}`` + blank-line terminator."""
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


def sse_done() -> bytes:
    return b"data: " + DONE.encode() + b"\n\n"


class SSEWriter:
    """Streams SSE events over a ``BaseHTTPRequestHandler`` using
    chunked transfer encoding (the same wire idiom as the worker's
    ``/worker_generate_stream`` JSON-lines endpoint, different frame
    grammar). Headers are sent lazily on the first event so a request
    that fails during translation still gets a plain JSON error."""

    def __init__(self, handler, trace_id: Optional[str] = None):
        self._h = handler
        self._trace = trace_id
        self.started = False
        self.events = 0

    def _start(self):
        h = self._h
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Transfer-Encoding", "chunked")
        if self._trace:
            from bigdl_tpu_torch.observability import request_context as rc
            h.send_header(rc.TRACE_HEADER, self._trace)
        h.end_headers()
        self.started = True

    def _chunk(self, data: bytes):
        try:
            self._h.wfile.write(f"{len(data):x}\r\n".encode() + data
                                + b"\r\n")
            self._h.wfile.flush()
        except OSError as e:
            # client hung up mid-stream: the gateway aborts the engine
            # request (slot + KV pages free) instead of generating
            # tokens nobody will read
            raise StreamAbort("client disconnected mid-stream",
                              client_gone=True) from e

    def event(self, obj):
        if not self.started:
            self._start()
        self._chunk(sse_event(obj))
        self.events += 1

    def done(self):
        """Terminal ``data: [DONE]`` + the zero-length chunk that ends
        the HTTP response."""
        if not self.started:
            self._start()
        self._chunk(sse_done())
        try:
            self._h.wfile.write(b"0\r\n\r\n")
            self._h.wfile.flush()
        except OSError:
            # the payload was fully delivered — a reset racing the
            # trailer is not a client-visible failure
            pass


def parse_sse(resp) -> Iterator[dict]:
    """Client-side SSE reader over an ``http.client`` response (which
    undoes the chunked framing): yields one parsed JSON object per
    ``data:`` event, stopping at ``[DONE]``. Raises ``ValueError`` on
    grammar violations — the chaos/parity harnesses want framing bugs
    loud, not skipped."""
    for raw in resp:
        line = raw.strip()
        if not line:
            continue
        if not line.startswith(b"data:"):
            raise ValueError(f"not an SSE data line: {raw[:80]!r}")
        payload = line[len(b"data:"):].strip()
        if payload == DONE.encode():
            return
        yield json.loads(payload.decode())
    raise ValueError("SSE stream ended without data: [DONE]")
