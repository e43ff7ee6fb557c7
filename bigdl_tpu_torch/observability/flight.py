"""Engine flight recorder: a causal ledger of serving *decisions* — the
port of ``bigdl_tpu/observability/flight.py``.

The metric families tell an operator *how often* the engine sheds,
evicts, fetches, forks, fails over — but when one request is slow the
operator has to mentally join six of them. The flight recorder keeps a
bounded, thread-safe ring of typed decision events, each stamped with
the request id and the trace id, so the full causal chain behind
one outcome can be replayed:

- ``GET /debug/explain/<request_id>`` — the assembled, causally ordered
  timeline for one request (trace-id stitched across the router/worker
  boundary) plus a one-line verdict, e.g. ``"slow TTFT: radix miss ->
  2 tier fetches parked 41 ms -> chunked admission, 3 chunks"``;
- ``GET /debug/flight`` — the recent ring, filterable by ``?kind=`` /
  ``?request=`` / ``?limit=``.

Event kinds (the JAX package's catalog):
``queue admit radix_hit radix_miss cow_fork park fetch chunk_charge
rollback shed evict spill failover hedge drain_migrate scale_out
scale_in finish``.

Master switch: ``bigdl.observability.flight.enabled`` (default off).
Disabled means structurally absent: :func:`record` is a single
attribute check and returns, the ring is never constructed, the
``bigdl_flight_events_total`` series never appears in the registry,
and both endpoints 404. Ring capacity:
``bigdl.observability.flight.capacity`` (events, oldest dropped).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from bigdl_tpu_torch.utils.conf import conf

#: The typed decision-event vocabulary. record() does not enforce
#: membership (forward compatibility for tools reading saved rings),
#: but everything the engine emits is listed here and in the docs.
EVENT_KINDS: Tuple[str, ...] = (
    "queue", "admit", "radix_hit", "radix_miss", "cow_fork", "park",
    "fetch", "chunk_charge", "rollback", "shed", "evict", "spill",
    "failover", "hedge", "drain_migrate", "scale_out", "scale_in",
    "preempt", "preempt_resume", "finish", "alert_fire",
    "alert_resolve", "draft", "verify_accept", "verify_reject",
    "client_abort",
)


def _initial() -> bool:
    return conf.get_bool("bigdl.observability.flight.enabled", False)


#: Module-attribute gate, poked by ``_state.refresh`` on conf.set — the
#: hot-path check at every decision point is one attribute read.
enabled: bool = _initial()

_lock = threading.Lock()
_ring: Optional["FlightRing"] = None      # built on first enabled record()
_seq = itertools.count(1)                 # process-wide causal order
_ins: Optional[Dict[str, Any]] = None     # lazy bigdl_flight_events_total


class FlightRing:
    """Bounded thread-safe ring of event dicts, oldest evicted first
    (same head-ring layout as :class:`tracing.TraceBuffer`)."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._buf: List[Dict[str, Any]] = []
        self._head = 0
        self.dropped = 0

    def append(self, ev: Dict[str, Any]):
        with self._lock:
            if len(self._buf) < self.capacity:
                self._buf.append(ev)
            else:
                self._buf[self._head] = ev
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1

    def events(self, kind: Optional[str] = None,
               request_id: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Oldest-first snapshot, optionally filtered; ``limit`` keeps
        the most recent N after filtering."""
        with self._lock:
            out = self._buf[self._head:] + self._buf[:self._head]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        if request_id is not None:
            out = [e for e in out if e.get("request") == request_id]
        if limit is not None and limit > 0:
            out = out[-limit:]
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
        with self._lock:
            keep = self._buf[self._head:] + self._buf[:self._head]
            self.capacity = max(int(capacity), 1)
            self._buf = keep[-self.capacity:]
            self._head = 0


def ring() -> Optional[FlightRing]:
    """The live ring, or None when no event was ever recorded (the
    structural-absence invariant tests assert on)."""
    return _ring


def _get_ring() -> FlightRing:
    global _ring
    with _lock:
        if _ring is None:
            _ring = FlightRing(
                conf.get_int("bigdl.observability.flight.capacity", 4096))
        return _ring


def set_capacity(capacity: int):
    with _lock:
        if _ring is not None:
            _ring.set_capacity(capacity)


def _instruments() -> Optional[Dict[str, Any]]:
    global _ins
    from bigdl_tpu_torch import observability as obs
    if not obs.enabled():
        return None
    if _ins is None:
        _ins = {"events": obs.counter(
            "bigdl_flight_events_total",
            "Flight-recorder decision events by kind",
            labelnames=("kind",))}
    return _ins


def record(kind: str, request_id=None, trace_id: Optional[str] = None,
           **detail):
    """Record one decision event. No-op (one attribute check) when the
    flight recorder is disabled. ``trace_id`` defaults to the ambient
    request context so events stitch into the trace model without
    every call site having to thread it through."""
    if not enabled:
        return
    if trace_id is None:
        from bigdl_tpu_torch.observability import request_context as rc
        cur = rc.current()
        if cur is not None:
            trace_id = cur.trace_id
    ev: Dict[str, Any] = {"seq": next(_seq), "ts": time.time(),
                          "kind": kind}
    if request_id is not None:
        ev["request"] = str(request_id)
    if trace_id:
        ev["trace"] = str(trace_id)
    extra = {k: v for k, v in detail.items() if v is not None}
    if extra:
        ev["detail"] = extra
    _get_ring().append(ev)
    ins = _instruments()
    if ins is not None:
        ins["events"].labels(kind=kind).inc()


# ---------------------------------------------------------------------------
# explain: assembled causal timeline + verdict
# ---------------------------------------------------------------------------

def _fmt_ms(ms: float) -> str:
    return f"{ms:.0f} ms" if ms >= 1 else f"{ms:.2f} ms"


def _verdict(events: List[Dict[str, Any]]) -> str:
    """One-line causal summary, worst decision first. Heuristics are
    the JAX package's."""
    if not events:
        return "no recorded events"
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        by_kind.setdefault(e["kind"], []).append(e)
    if "shed" in by_kind:
        d = by_kind["shed"][-1].get("detail", {})
        why = d.get("reason") or d.get("component") or "admission"
        return f"shed: {why}"
    parts: List[str] = []
    if "radix_hit" in by_kind:
        d = by_kind["radix_hit"][-1].get("detail", {})
        parts.append(f"radix hit ({d.get('matched_tokens', '?')} tokens "
                     "reused)")
    elif "radix_miss" in by_kind:
        parts.append("radix miss")
    if "cow_fork" in by_kind:
        parts.append("COW fork")
    fetches = by_kind.get("fetch", [])
    if fetches:
        wait_ms = sum(e.get("detail", {}).get("wait_ms", 0.0)
                      for e in fetches)
        n = len(fetches)
        parts.append(f"{n} tier fetch{'es' if n != 1 else ''} parked "
                     f"{_fmt_ms(wait_ms)}")
        if any(e.get("detail", {}).get("status") == "degraded"
               for e in fetches):
            parts.append("degraded to recompute")
    chunks = by_kind.get("chunk_charge", [])
    if chunks:
        parts.append(f"chunked admission, {len(chunks)} "
                     f"chunk{'s' if len(chunks) != 1 else ''}")
    if "rollback" in by_kind:
        d = by_kind["rollback"][-1].get("detail", {})
        parts.append(f"rolled back ({d.get('reason', 'starved')})")
    if "evict" in by_kind:
        pages = sum(e.get("detail", {}).get("pages", 0)
                    for e in by_kind["evict"])
        parts.append(f"evicted {pages} pages")
    n_fo = len(by_kind.get("failover", []))
    if n_fo:
        parts.append(f"{n_fo} mid-stream failover "
                     f"resume{'s' if n_fo != 1 else ''}")
    if "hedge" in by_kind:
        parts.append(f"{len(by_kind['hedge'])} hedged")
    if "drain_migrate" in by_kind:
        parts.append("migrated on drain")
    if not parts:
        parts.append("clean admission")
    ttft_ms = None
    fin = by_kind.get("finish")
    if fin:
        ttft_ms = fin[-1].get("detail", {}).get("ttft_ms")
    slo_ms = conf.get_float("bigdl.slo.ttft_ms", 500.0)
    if ttft_ms is not None and ttft_ms > slo_ms:
        head = "slow TTFT"
    elif n_fo or any(e.get("detail", {}).get("status") == "degraded"
                     for e in fetches):
        head = "degraded"
    else:
        head = "ok"
    line = f"{head}: " + " -> ".join(parts)
    if ttft_ms is not None:
        line += f" (TTFT {_fmt_ms(ttft_ms)})"
    return line


def explain(request_id) -> Dict[str, Any]:
    """Causally ordered event timeline for one request. Events sharing
    any of the request's trace ids (router-side failover / hedge / shed
    decisions, which run under the same trace but a different local
    request id) are stitched in, ordered by the global sequence."""
    rid = str(request_id)
    r = _ring
    evs = r.events() if r is not None else []
    mine = [e for e in evs if e.get("request") == rid]
    traces = {e["trace"] for e in mine if e.get("trace")}
    if traces:
        mine += [e for e in evs
                 if e.get("request") != rid and e.get("trace") in traces]
        mine.sort(key=lambda e: e["seq"])
    return {"request": rid, "traces": sorted(traces),
            "verdict": _verdict(mine), "events": mine}


# ---------------------------------------------------------------------------
# HTTP surface (shared helper: see tracing.debug_endpoint)
# ---------------------------------------------------------------------------

def debug_endpoint(path: str):
    """Serve the flight GET endpoints for any HTTP handler. Returns
    ``(status, jsonable)`` for paths this module owns — including the
    404 arms when the recorder is disabled — or ``None`` for paths it
    does not serve. Keeps worker and router surfaces identical."""
    parts = urlsplit(path)
    p = parts.path
    if p == "/debug/flight":
        if not enabled:
            return 404, {"error": "flight recorder disabled"}
        q = parse_qs(parts.query)
        kind = (q.get("kind") or [None])[0]
        request = (q.get("request") or [None])[0]
        try:
            limit = int((q.get("limit") or ["0"])[0]) or None
        except (TypeError, ValueError):
            limit = None
        r = _ring
        events = (r.events(kind=kind, request_id=request, limit=limit)
                  if r is not None else [])
        return 200, {"enabled": True,
                     "capacity": (r.capacity if r is not None else
                                  conf.get_int(
                                      "bigdl.observability.flight.capacity",
                                      4096)),
                     "dropped": r.dropped if r is not None else 0,
                     "kinds": sorted({e["kind"] for e in events}),
                     "events": events}
    if p.startswith("/debug/explain/"):
        if not enabled:
            return 404, {"error": "flight recorder disabled"}
        rid = p[len("/debug/explain/"):].strip("/")
        doc = explain(rid)
        if not doc["events"]:
            return 404, {"error": f"no flight events for request {rid!r}"}
        return 200, doc
    return None


def reset():
    """Drop the ring and cached instruments — test isolation (wired
    into ``obs.reset()``)."""
    global _ring, _ins
    with _lock:
        _ring = None
        _ins = None


__all__ = [
    "EVENT_KINDS", "FlightRing", "debug_endpoint", "enabled", "explain",
    "record", "reset", "ring", "set_capacity",
]
