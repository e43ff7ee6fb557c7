"""Request-scoped distributed trace context — the port of
``bigdl_tpu/observability/request_context.py``, headers and wire form
unchanged, so traces stitch across the two packages.

A :class:`TraceContext` is the W3C-traceparent-shaped identity of one
end-to-end request: a 128-bit ``trace_id`` shared by every span the
request touches in any process, and a 64-bit ``span_id`` naming the
*currently open* span (the parent of whatever starts next). It rides:

- an ambient **contextvar** inside a process (``activate(ctx)``), which
  :func:`bigdl_tpu_torch.observability.tracing.span` reads — every span opened
  under an active context is tagged ``trace``/``span``/``parent_span``
  in its args, so the existing ``span()`` call sites stitch into
  cross-process traces without being rewritten;
- HTTP headers ``X-BigDL-Trace-Id`` / ``X-BigDL-Parent-Span`` between
  services (read case-insensitively on both ends — HTTP header names
  carry no case);
- the ClusterServing queue records (a small ``trace`` dict next to the
  existing ``uri`` correlation key, plus ``enqueued_at`` so the consumer
  can attribute queue wait).

Disabled mode (``bigdl.observability.enabled`` False): extraction
returns None, injection emits nothing, and no context is ever activated
— the wire and headers carry no trace at all.
"""

from __future__ import annotations

import contextvars
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from bigdl_tpu_torch.observability import _state

#: Header carrying the 128-bit trace id (32 hex chars) downstream.
TRACE_HEADER = "X-BigDL-Trace-Id"
#: Header carrying the caller's open span id (16 hex chars) — the
#: parent of the first span the callee opens.
PARENT_HEADER = "X-BigDL-Parent-Span"


class TraceContext:
    """Immutable value object: one request's identity at one point in
    the call tree. ``span_id`` may be empty for a context extracted from
    a caller that sent only a trace id."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str = "",
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def __repr__(self):
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r})")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id)

    def child(self) -> "TraceContext":
        """A fresh span identity under the same trace, parented here."""
        return TraceContext(self.trace_id, new_span_id(),
                            parent_id=self.span_id or None)


def new_trace_id() -> str:
    """128-bit trace id, 32 lowercase hex chars."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """64-bit span id, 16 lowercase hex chars."""
    return uuid.uuid4().hex[:16]


def new_trace() -> TraceContext:
    """Root context for a request that arrived without trace headers."""
    return TraceContext(new_trace_id(), new_span_id())


_current: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("bigdl_trace_context", default=None)


def current() -> Optional[TraceContext]:
    """The ambient context of this thread/task, or None."""
    return _current.get()


@contextmanager
def activate(ctx: Optional[TraceContext]) -> Iterator[
        Optional[TraceContext]]:
    """Make ``ctx`` the ambient context for the block. ``None`` (or
    disabled observability) is a no-op — callers can pass whatever
    extraction returned without branching."""
    if ctx is None or not _state.enabled:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


# -- header carriage ---------------------------------------------------------

def _ci_get(headers: Any, name: str) -> Optional[str]:
    """Case-insensitive header lookup over http.client/http.server
    message objects (already case-insensitive) AND plain dicts (not)."""
    get = getattr(headers, "get", None)
    if get is None:
        return None
    value = get(name)
    if value is not None:
        return value
    if isinstance(headers, dict):
        lname = name.lower()
        for k, v in headers.items():
            if isinstance(k, str) and k.lower() == lname:
                return v
    return None


def from_headers(headers: Any) -> Optional[TraceContext]:
    """Extract the caller's context from request headers (any casing).
    None when no trace header arrived or observability is disabled."""
    if not _state.enabled:
        return None
    trace_id = _ci_get(headers, TRACE_HEADER)
    if not trace_id:
        return None
    trace_id = str(trace_id).strip().lower()
    if not trace_id:
        return None
    parent = _ci_get(headers, PARENT_HEADER)
    return TraceContext(trace_id, str(parent).strip().lower()
                        if parent else "")


def to_headers(ctx: Optional[TraceContext]) -> List[Tuple[str, str]]:
    """Header pairs propagating ``ctx`` downstream; [] when there is no
    context or observability is disabled (the no-header contract)."""
    if ctx is None or not _state.enabled:
        return []
    out = [(TRACE_HEADER, ctx.trace_id)]
    if ctx.span_id:
        out.append((PARENT_HEADER, ctx.span_id))
    return out


def server_context(headers: Any) -> Optional[TraceContext]:
    """What an HTTP handler should activate: the caller's context when
    trace headers arrived, else a brand-new root trace. None only when
    observability is disabled."""
    if not _state.enabled:
        return None
    return from_headers(headers) or new_trace()


# -- queue-record carriage ---------------------------------------------------

def to_wire(ctx: Optional[TraceContext]) -> Optional[Dict[str, str]]:
    """Serializable dict for queue records (ppml wire protocol: str
    values only). None when nothing should be emitted."""
    if ctx is None or not _state.enabled:
        return None
    out = {"trace_id": ctx.trace_id}
    if ctx.span_id:
        out["parent_span"] = ctx.span_id
    return out


def from_wire(blob: Any) -> Optional[TraceContext]:
    if not _state.enabled or not isinstance(blob, dict):
        return None
    trace_id = blob.get("trace_id")
    if not trace_id:
        return None
    return TraceContext(str(trace_id), str(blob.get("parent_span") or ""))
