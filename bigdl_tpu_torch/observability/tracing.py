"""Trace spans → in-memory ring buffer → Chrome-trace/Perfetto JSON — the
port of ``bigdl_tpu/observability/tracing.py``.

``with span("train/step", step=i):`` brackets a host-side phase; completed
spans land in a fixed-capacity ring buffer (old entries fall off — a
long-running server never grows without bound) and can be exported as
Chrome trace-event JSON (``chrome://tracing`` / https://ui.perfetto.dev
both load it directly).

Span records are "X" (complete) events: name, ``ts``/``dur`` in
microseconds, ``pid``/``tid``, free-form ``args``. Nesting is tracked per
thread with a thread-local stack — the exported depth is what the trace
viewers use to stack the flame graph, and ``parent`` in args keeps the
relationship greppable in the raw JSON.

Optional torch profiler passthrough: ``configure(torch_passthrough=True)``
additionally enters ``torch.profiler.record_function(name)`` around each
span (where the JAX package enters ``jax.profiler``'s annotations), so
the same ``span(...)`` sites label a torch profiler trace, device
kernels nested under them, when one is being captured. Off by default
(it is not free) and skipped when the profiler is unavailable.

Disabled mode (:func:`bigdl_tpu_torch.observability.enabled` False): ``span``
yields immediately — no clock reads, no buffer writes, no allocations
beyond its own generator frame.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from bigdl_tpu_torch.observability import _state


def _default_capacity() -> int:
    try:
        from bigdl_tpu_torch.utils.conf import conf
        return conf.get_int("bigdl.observability.trace.capacity", 65536)
    except Exception:
        return 65536


class TraceBuffer:
    """Fixed-capacity ring of completed span records (dicts in
    trace-event form). Thread-safe; ``capacity`` bounds host memory."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity if capacity is not None \
            else _default_capacity()
        self._lock = threading.Lock()
        self._buf: List[Dict[str, Any]] = []
        self._head = 0          # insertion point once the ring is full
        self.dropped = 0

    def append(self, rec: Dict[str, Any]):
        with self._lock:
            if self.capacity <= 0:     # capacity 0 = tracing off
                self.dropped += 1
                return
            if len(self._buf) < self.capacity:
                self._buf.append(rec)
            else:
                self._buf[self._head] = rec
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1

    def spans(self) -> List[Dict[str, Any]]:
        """Records in arrival order."""
        with self._lock:
            return self._buf[self._head:] + self._buf[:self._head]

    def for_trace(self, trace_id: str) -> List[Dict[str, Any]]:
        """Every retained span tagged with ``trace_id`` (the per-request
        assembly behind ``GET /debug/trace/<id>``), in start order."""
        out = [r for r in self.spans()
               if r.get("args", {}).get("trace") == trace_id]
        out.sort(key=lambda r: r.get("ts", 0.0))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self):
        with self._lock:
            self._buf = []
            self._head = 0
            self.dropped = 0

    def set_capacity(self, capacity: int):
        """Resize in place (the module-level ``TRACE`` is imported by
        value all over; rebinding it would strand those references).
        Keeps the newest ``capacity`` spans."""
        with self._lock:
            ordered = self._buf[self._head:] + self._buf[:self._head]
            self.capacity = int(capacity)
            self._buf = ordered[-self.capacity:] if self.capacity > 0 \
                else []
            self._head = 0

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """Chrome trace-event JSON. Returns the JSON string; writes it to
        ``path`` when given (parent dirs created)."""
        doc = {"traceEvents": self.spans(), "displayTimeUnit": "ms"}
        text = json.dumps(doc)
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
        return text


TRACE = TraceBuffer()

_tls = threading.local()
_torch_passthrough = False


def configure(torch_passthrough: Optional[bool] = None,
              capacity: Optional[int] = None):
    """Adjust tracing runtime knobs. ``capacity`` resizes the ring
    buffer in place (newest spans kept)."""
    global _torch_passthrough
    if torch_passthrough is not None:
        _torch_passthrough = bool(torch_passthrough)
    if capacity is not None:
        TRACE.set_capacity(capacity)


def _stack() -> List[str]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _torch_annotation(name: str):
    try:
        import torch
        return torch.profiler.record_function(name)
    except Exception:
        return None


@contextmanager
def span(name: str, **args: Any) -> Iterator[None]:
    """Record a host-side phase. Nestable; thread-aware; a no-op when
    observability is disabled.

    When a :mod:`~bigdl_tpu_torch.observability.request_context` is active
    (``activate(ctx)``), the span is additionally tagged with the
    request's ``trace``/``span``/``parent_span`` ids and becomes the
    ambient parent for anything opened inside it — the mechanism that
    stitches existing ``span()`` sites into cross-process traces."""
    if not _state.enabled:
        yield
        return
    from bigdl_tpu_torch.observability import request_context as rc
    stack = _stack()
    parent = stack[-1] if stack else None
    stack.append(name)
    ctx = rc.current()
    token = None
    if ctx is not None:
        # this span's own identity; children parent to it via the
        # contextvar for the duration of the block
        ctx = ctx.child()
        token = rc._current.set(ctx)
    ann = _torch_annotation(name) if _torch_passthrough else None
    if ann is not None:
        try:
            ann.__enter__()
        except Exception:
            # a profiler-state hiccup must not crash the instrumented
            # loop or leak the stack entry we just pushed
            ann = None
    t0 = time.perf_counter()
    wall0 = time.time()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:
                pass
        stack.pop()
        if token is not None:
            rc._current.reset(token)
        rec_args = {k: v for k, v in args.items()}
        if parent is not None:
            rec_args["parent"] = parent
        if ctx is not None:
            rec_args["trace"] = ctx.trace_id
            rec_args["span"] = ctx.span_id
            if ctx.parent_id:
                rec_args["parent_span"] = ctx.parent_id
        TRACE.append({
            "name": name,
            "ph": "X",
            "ts": wall0 * 1e6,            # trace-event ts is microseconds
            "dur": dur * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": rec_args,
        })


def make_complete(name: str, start_wall: float, dur_s: float,
                  **args: Any) -> Dict[str, Any]:
    """Build (but do not record) a complete ("X") event record — the
    one schema owner, so hand-built dicts and shipped-across-processes
    spans can't drift from ``span``'s. ``start_wall`` is epoch
    seconds."""
    return {
        "name": name,
        "ph": "X",
        "ts": start_wall * 1e6,
        "dur": dur_s * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": dict(args),
    }


def add_complete(name: str, start_wall: float, dur_s: float,
                 **args: Any):
    """Record an already-measured phase as a complete ("X") event — for
    call sites that timed the work themselves and must not re-bracket
    it. No-op when disabled."""
    if not _state.enabled:
        return
    TRACE.append(make_complete(name, start_wall, dur_s, **args))


def export_chrome_trace(path: Optional[str] = None) -> str:
    return TRACE.export_chrome_trace(path)


# ---------------------------------------------------------------------------
# Latency exemplars: the slowest-N request traces, by id
# ---------------------------------------------------------------------------

def _default_exemplar_capacity() -> int:
    try:
        from bigdl_tpu_torch.utils.conf import conf
        return conf.get_int("bigdl.observability.exemplars", 8)
    except Exception:
        return 8


class ExemplarStore:
    """Slowest-N request exemplars: (latency, trace_id, meta) kept
    sorted, so an operator asking "what do my p99 requests look like"
    gets concrete trace ids to feed ``GET /debug/trace/<id>`` /
    the JAX package's ``tools/trace_report.py`` instead of an aggregate. The store holds
    ids, not spans — the spans live in the ring buffer (an exemplar of a
    very old request may therefore have partially fallen off; capacity
    the ring accordingly)."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity if capacity is not None \
            else _default_exemplar_capacity()
        self._lock = threading.Lock()
        self._items: List[Dict[str, Any]] = []   # sorted slowest-first

    def offer(self, trace_id: str, duration_s: float, **meta: Any):
        """Consider one finished request for retention. No-op when
        observability is disabled."""
        if not _state.enabled or not trace_id:
            return
        rec = {"trace_id": trace_id, "duration_s": float(duration_s),
               **meta}
        with self._lock:
            if self.capacity <= 0:
                return
            # one slot per trace id: a retried offer updates in place
            self._items = [r for r in self._items
                           if r["trace_id"] != trace_id]
            self._items.append(rec)
            self._items.sort(key=lambda r: -r["duration_s"])
            del self._items[self.capacity:]

    def items(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._items)

    def clear(self):
        with self._lock:
            self._items = []


EXEMPLARS = ExemplarStore()


def assemble_trace(trace_id: str) -> Dict[str, Any]:
    """Per-request span assembly: every retained span of one trace plus
    the per-stage rollup — the body ``GET /debug/trace/<id>`` serves and
    the input ``tools/trace_report.py`` renders as a waterfall."""
    spans = TRACE.for_trace(trace_id)
    stages: Dict[str, Dict[str, float]] = {}
    t0 = min((s["ts"] for s in spans), default=0.0)
    t1 = max((s["ts"] + s.get("dur", 0.0) for s in spans), default=0.0)
    for s in spans:
        stage = s.get("args", {}).get("stage", s["name"])
        agg = stages.setdefault(stage, {"count": 0, "seconds": 0.0})
        agg["count"] += 1
        agg["seconds"] += s.get("dur", 0.0) / 1e6
    return {"trace_id": trace_id, "span_count": len(spans),
            "wall_s": max(t1 - t0, 0.0) / 1e6, "stages": stages,
            "spans": spans}


def debug_endpoint(path: str):
    """Shared ``GET /debug/trace*`` handling for the HTTP surfaces
    (ServingFrontend and LLMWorker serve identical bodies). Returns
    ``(status, json-able dict)`` or None when ``path`` is not ours.
    Disabled observability answers 404 — the surface is structurally
    absent, not empty."""
    if path == "/debug/traces":
        if not _state.enabled:
            return 404, {"error": "observability disabled"}
        return 200, {"exemplars": EXEMPLARS.items()}
    if path.startswith("/debug/trace/"):
        if not _state.enabled:
            return 404, {"error": "observability disabled"}
        trace_id = path[len("/debug/trace/"):].strip("/")
        asm = assemble_trace(trace_id)
        if not asm["span_count"]:
            return 404, {"error": f"no retained spans for trace "
                                  f"{trace_id!r}", "trace_id": trace_id}
        return 200, asm
    return None
