"""In-process time-series plane — the port of
``bigdl_tpu/observability/timeseries.py``: a windowed metric store.

The registry exports *cumulative* state; every consumer that needs a
rate or a window (the fleet autoscaler's shed deltas, the SLO burn
gauges, the alert engine) reads it through this module's math: a
bounded ring of periodic :func:`~bigdl_tpu_torch.observability.
federation.registry_snapshot` documents plus typed window queries over
it —

- **counter** ``delta``/``rate`` with counter-reset detection (a value
  that drops means the process restarted; the post-reset value is all
  new increase, never a negative delta);
- **gauge** ``avg``/``min``/``max``/``last``;
- **histogram** bucket subtraction (windowed count/sum/mean);
- **sketch** snapshot subtraction — :func:`sketch_window`: bucket counts
  only grow, so the bucket-wise difference of two snapshots of one
  cumulative sketch is itself a valid sketch of exactly the window's
  samples. A gamma (alpha) mismatch or a count drop between snapshots
  means a restart/reconfiguration: the ``after`` snapshot passes
  through whole instead of a lying subtraction.

Served as ``GET /metrics/query?series=&window=&fn=`` on every HTTP
surface and ``GET /fleet/timeline`` (per-member + merged series over
time). With a federation collector attached the store samples the
collector's *cached* member snapshots — fleet-wide timelines ride the
collector's scrape cache, no extra scrapes. Stale members are excluded
at sample time and departed members stop appearing in new samples, so
merged windows only ever aggregate members alive in the window's most
recent sample. The documents, the queries and the endpoint bodies are
the JAX package's, so a mixed fleet answers alike.

Host code only: the sampler thread reads the registry (and the
collector's cache), never an engine or the device.

Master switch: ``bigdl.observability.timeseries.enabled`` (default
off). Disabled means structurally absent: no sampler thread, no ring,
no ``bigdl_timeseries_*``/``bigdl_alerts_*`` series, and the three
endpoints 404. Knobs: ``bigdl.observability.timeseries.interval``
(sampler cadence, seconds) and ``.retention`` (window of history kept,
seconds; older samples are evicted). The alert engine
(:mod:`~bigdl_tpu_torch.observability.alerts`) shares this gate and
rides the sampler tick.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from bigdl_tpu_torch.utils.conf import conf

NAN = float("nan")


def _initial() -> bool:
    return conf.get_bool("bigdl.observability.timeseries.enabled", False)


#: Module-attribute gate, poked by ``_state.refresh`` on conf.set —
#: the same idiom as the flight recorder's switch.
enabled: bool = _initial()

_lock = threading.Lock()
_store: Optional["TimeSeriesStore"] = None   # built on first acquire()
_refs = 0                                    # serving surfaces holding it
_ins: Optional[Dict[str, Any]] = None        # lazy bigdl_timeseries_*


# ---------------------------------------------------------------------------
# window math primitives (pure — usable with the gate off; the gated
# state is the ring/thread/series, not the arithmetic)
# ---------------------------------------------------------------------------

def counter_delta(values: List[float]) -> float:
    """Increase across consecutive samples of one cumulative counter,
    with counter-reset detection: a drop means the process restarted,
    so the post-reset value counts as new increase. NaN below two
    samples (the empty-window contract)."""
    if len(values) < 2:
        return NAN
    total = 0.0
    for prev, cur in zip(values, values[1:]):
        total += cur if cur < prev else cur - prev
    return total


def counter_rate(points: List[Tuple[float, float]]) -> float:
    """Per-second increase over ``[(ts, value), ...]`` (reset-aware).
    NaN below two samples or on a zero-length span."""
    if len(points) < 2:
        return NAN
    span = points[-1][0] - points[0][0]
    if span <= 0:
        return NAN
    return counter_delta([v for _, v in points]) / span


def gauge_stats(values: List[float]) -> Dict[str, float]:
    """``avg``/``min``/``max``/``last`` over a window's gauge samples;
    all NaN when the window is empty."""
    if not values:
        return {"avg": NAN, "min": NAN, "max": NAN, "last": NAN}
    return {"avg": sum(values) / len(values), "min": min(values),
            "max": max(values), "last": values[-1]}


def histogram_delta(first: Optional[dict],
                    last: Optional[dict]) -> Dict[str, float]:
    """Windowed count/sum/mean of one cumulative histogram via bucket
    subtraction. A count drop means a restart: the ``last`` snapshot
    passes through whole. NaN fields when either end is missing."""
    if first is None or last is None:
        return {"count": NAN, "sum": NAN, "avg": NAN}
    c0, c1 = int(first.get("count", 0)), int(last.get("count", 0))
    s0, s1 = float(first.get("sum", 0.0)), float(last.get("sum", 0.0))
    if c1 < c0 or first.get("bounds") != last.get("bounds"):
        dc, ds = c1, s1                      # restart / relayout
    else:
        dc, ds = c1 - c0, s1 - s0
    return {"count": float(dc), "sum": ds,
            "avg": (ds / dc) if dc > 0 else NAN}


def sketch_delta(before: Optional[dict],
                 after: Optional[dict]) -> Optional[dict]:
    """Bucket-wise difference of two snapshots of one cumulative
    quantile sketch — a valid sketch of exactly the window's samples.
    ``before`` None (series was born inside the window), a gamma/alpha
    mismatch (sketch reconfigured across a restart) or a count drop
    (plain restart) all pass ``after`` through whole: subtraction
    across those boundaries would fabricate samples."""
    if after is None:
        return None
    if before is None:
        return dict(after)
    if before.get("gamma") != after.get("gamma") or \
            int(after.get("count", 0)) < int(before.get("count", 0)):
        return dict(after)
    delta = {
        "alpha": after["alpha"],
        "gamma": after["gamma"],
        "zero": int(after.get("zero", 0)) - int(before.get("zero", 0)),
        "count": int(after.get("count", 0))
        - int(before.get("count", 0)),
        "sum": float(after.get("sum", 0.0))
        - float(before.get("sum", 0.0)),
        # min/max cannot be windowed; the after-run envelope is the
        # honest conservative stand-in (quantiles read buckets only)
        "min": after.get("min"),
        "max": after.get("max"),
        "buckets": {},
    }
    bb = before.get("buckets", {})
    for k, c in after.get("buckets", {}).items():
        d = int(c) - int(bb.get(k, 0))
        if d > 0:
            delta["buckets"][k] = d
    return delta


def sketch_window(before: Optional[dict], after: Optional[dict],
                  qs=(0.5, 0.95, 0.99)) -> Dict[float, Optional[float]]:
    """Quantiles of the samples observed BETWEEN two snapshots of one
    cumulative sketch (the store's ``p..`` queries use it too)."""
    from bigdl_tpu_torch.observability.sketch import QuantileSketch
    delta = sketch_delta(before, after)
    if delta is None or int(delta.get("count", 0)) <= 0:
        return {q: None for q in qs}
    return QuantileSketch.from_snapshot(delta).quantiles(qs)


class WindowedCounter:
    """Per-key cumulative-counter tracker: each :meth:`observe` returns
    the summed reset-aware increase since the previous observation.
    Keys are member instances — a restarted member's counter drop is a
    reset for THAT member only, and departed keys stop contributing
    (this replaces the fleet autoscaler's private shed-delta
    bookkeeping)."""

    def __init__(self):
        self._last: Dict[str, float] = {}

    def observe(self, values: Dict[str, float]) -> float:
        total = 0.0
        for key, cur in values.items():
            cur = float(cur)
            prev = self._last.get(key)
            if prev is not None:
                total += cur if cur < prev else cur - prev
            self._last[key] = cur
        for gone in set(self._last) - set(values):
            del self._last[gone]
        return total


# ---------------------------------------------------------------------------
# the windowed store
# ---------------------------------------------------------------------------

def _extract(doc: dict, name: str,
             labels: Optional[Dict[str, str]]) -> Optional[Tuple[str, Any]]:
    """``(kind, payload)`` for one series of one snapshot document —
    scalar (counter/gauge summed over matching children), histogram
    accumulator, or sketch snapshot. None when absent."""
    for m in doc.get("metrics", []):
        if m.get("name") != name:
            continue
        kind = m.get("kind", "")
        lnames = list(m.get("labelnames", []))
        scalar = None
        hist = None
        sk = None
        for s in m.get("series", []):
            lv = dict(zip(lnames, [str(v) for v in s.get("labels", [])]))
            if labels and any(lv.get(k) != str(v)
                              for k, v in labels.items()):
                continue
            if "sketch" in s:
                if sk is None:
                    sk = dict(s["sketch"])
                else:
                    nxt = s["sketch"]
                    if sk.get("gamma") == nxt.get("gamma"):
                        sk["zero"] = int(sk.get("zero", 0)) + \
                            int(nxt.get("zero", 0))
                        sk["count"] = int(sk.get("count", 0)) + \
                            int(nxt.get("count", 0))
                        sk["sum"] = float(sk.get("sum", 0.0)) + \
                            float(nxt.get("sum", 0.0))
                        buckets = dict(sk.get("buckets", {}))
                        for k, c in nxt.get("buckets", {}).items():
                            buckets[k] = int(buckets.get(k, 0)) + int(c)
                        sk["buckets"] = buckets
            elif "cum" in s:
                if hist is None:
                    hist = {"bounds": list(s.get("bounds", [])),
                            "cum": list(s.get("cum", [])),
                            "sum": float(s.get("sum", 0.0)),
                            "count": int(s.get("count", 0))}
                elif hist["bounds"] == list(s.get("bounds", [])):
                    hist["cum"] = [a + b for a, b in
                                   zip(hist["cum"], s.get("cum", []))]
                    hist["sum"] += float(s.get("sum", 0.0))
                    hist["count"] += int(s.get("count", 0))
            else:
                scalar = (scalar or 0.0) + float(s.get("value", 0.0))
        if sk is not None:
            return "summary", sk
        if hist is not None:
            return "histogram", hist
        if scalar is not None:
            return kind or "gauge", scalar
        if kind == "counter":
            # the family exists but no child matches the labels: a
            # counter child that has not been minted yet has counted
            # zero — so a series born mid-window deltas from 0 instead
            # of losing its first increments to the <2-points NaN
            return kind, 0.0
        return None
    return None


def _parse_q(fn: str) -> Optional[float]:
    """``p99`` -> 0.99, ``p99.9`` -> 0.999; None for non-quantile fns."""
    if not fn.startswith("p"):
        return None
    try:
        q = float(fn[1:]) / 100.0
    except ValueError:
        return None
    return q if 0.0 < q < 1.0 else None


class TimeSeriesStore:
    """Bounded ring of ``(ts, {instance: snapshot_doc})`` samples with
    typed window queries. The local registry is always sampled; an
    attached federation collector contributes its cached member
    snapshots (stale members excluded at sample time). ``clock`` is
    injectable and :meth:`sample_now` is the tests' fake tick — the
    thread exists only in production."""

    THREAD_NAME = "bigdl-timeseries-sampler"

    def __init__(self, interval: Optional[float] = None,
                 retention: Optional[float] = None,
                 clock: Callable[[], float] = time.time,
                 instance: str = "local"):
        self.interval = float(
            interval if interval is not None else conf.get_float(
                "bigdl.observability.timeseries.interval", 5.0))
        self.retention = float(
            retention if retention is not None else conf.get_float(
                "bigdl.observability.timeseries.retention", 600.0))
        self.instance = instance
        self.clock = clock
        self._lock = threading.Lock()
        self._samples: List[Tuple[float, Dict[str, dict]]] = []
        self._collector = None
        self.samples_total = 0
        self.evicted = 0
        self.last_overhead_us = 0.0
        #: called with (now) after every sample — the alert engine's tick
        self.on_sample: List[Callable[[float], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "TimeSeriesStore":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=self.THREAD_NAME, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 2.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.sample_now()
            except Exception:   # noqa: BLE001 — the sampler never dies
                pass

    def attach_collector(self, collector):
        self._collector = collector

    def detach_collector(self, collector):
        if self._collector is collector:
            self._collector = None

    # -- sampling ------------------------------------------------------------
    def local_instance(self) -> str:
        coll = self._collector
        if coll is not None and getattr(coll, "include_self", None):
            return coll.include_self
        return self.instance

    def sample_now(self, now: Optional[float] = None) -> float:
        """One synchronous sample (also the tests' fake clock — no
        sleeping). Returns the sample timestamp."""
        from bigdl_tpu_torch.observability.federation import registry_snapshot
        now = self.clock() if now is None else float(now)
        t0 = time.perf_counter()
        coll = self._collector
        if coll is not None:
            stale = set()
            try:
                stale = coll.stale_instances()
            except Exception:   # noqa: BLE001 — staleness is advisory
                pass
            docs = {inst: snap
                    for inst, snap in coll.snapshots().items()
                    if snap is not None and inst not in stale}
            if self.local_instance() not in docs:
                docs[self.local_instance()] = registry_snapshot(
                    instance=self.local_instance())
        else:
            docs = {self.instance: registry_snapshot(
                instance=self.instance)}
        overhead_us = (time.perf_counter() - t0) * 1e6
        with self._lock:
            self._samples.append((now, docs))
            floor = now - self.retention
            while self._samples and self._samples[0][0] < floor:
                self._samples.pop(0)
                self.evicted += 1
            self.samples_total += 1
            self.last_overhead_us = overhead_us
        self._record_instruments()
        for cb in list(self.on_sample):
            try:
                cb(now)
            except Exception:   # noqa: BLE001 — one bad rule must not
                pass            # kill the sampler
        return now

    def _record_instruments(self):
        ins = _instruments()
        if ins is not None:
            ins["samples"].inc()
            ins["overhead"].set(self.last_overhead_us)

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def _window(self, window: Optional[float],
                now: Optional[float] = None
                ) -> List[Tuple[float, Dict[str, dict]]]:
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return []
        now = samples[-1][0] if now is None else float(now)
        if window is None:
            window = self.retention
        floor = now - float(window)
        return [(ts, docs) for ts, docs in samples if floor <= ts <= now]

    def instances(self, window: Optional[float] = None,
                  now: Optional[float] = None) -> List[str]:
        """Members present in the window's most recent sample — the
        merged-query membership (departed/stale members are excluded
        by construction: they stop appearing in new samples)."""
        win = self._window(window, now)
        return sorted(win[-1][1]) if win else []

    def points(self, name: str, labels: Optional[Dict[str, str]] = None,
               instance: Optional[str] = None,
               window: Optional[float] = None,
               now: Optional[float] = None
               ) -> List[Tuple[float, str, Any]]:
        """``[(ts, kind, payload)]`` for one instance's series inside
        the window (instance None = the local registry)."""
        inst = instance or self.local_instance()
        out = []
        for ts, docs in self._window(window, now):
            doc = docs.get(inst)
            if doc is None:
                continue
            got = _extract(doc, name, labels)
            if got is not None:
                out.append((ts, got[0], got[1]))
        return out

    def query(self, name: str, fn: str = "last",
              window: Optional[float] = None,
              labels: Optional[Dict[str, str]] = None,
              instance: Optional[str] = None,
              now: Optional[float] = None) -> float:
        """One windowed value. ``fn``: ``delta``/``rate`` (counters,
        reset-aware; histograms use the windowed count),
        ``avg``/``min``/``max``/``last`` (gauges; histograms window the
        mean for ``avg``), ``p50``/``p99``/... (sketch subtraction).
        ``instance`` picks one member, ``"*"`` merges across the
        window's live members. NaN on an empty window — never 0, so a
        no-data window cannot impersonate an idle one."""
        if instance == "*":
            return self._query_merged(name, fn, window, labels, now)
        pts = self.points(name, labels, instance, window, now)
        return self._apply(fn, pts)

    def _apply(self, fn: str, pts: List[Tuple[float, str, Any]]) -> float:
        q = _parse_q(fn)
        if q is not None:
            snaps = [p for _, k, p in pts if k == "summary"]
            if len(snaps) < 2:
                return NAN
            counts = [int(s.get("count", 0)) for s in snaps]
            monotone = all(b >= a for a, b in zip(counts, counts[1:]))
            before = snaps[0] if monotone else None
            val = sketch_window(before, snaps[-1], (q,)).get(q)
            return NAN if val is None else float(val)
        hists = [(ts, p) for ts, k, p in pts if k == "histogram"]
        if hists:
            hd = histogram_delta(hists[0][1], hists[-1][1]) \
                if len(hists) >= 2 else {"count": NAN, "sum": NAN,
                                         "avg": NAN}
            if fn in ("delta", "count"):
                return hd["count"]
            if fn == "rate":
                span = hists[-1][0] - hists[0][0]
                return hd["count"] / span if span > 0 else NAN
            if fn == "avg":
                return hd["avg"]
            return gauge_stats([float(p["count"])
                                for _, p in hists]).get(fn, NAN)
        scalars = [(ts, float(p)) for ts, k, p in pts
                   if k not in ("summary", "histogram")]
        if fn == "delta":
            return counter_delta([v for _, v in scalars])
        if fn == "rate":
            return counter_rate(scalars)
        return gauge_stats([v for _, v in scalars]).get(fn, NAN)

    def _query_merged(self, name, fn, window, labels, now) -> float:
        from bigdl_tpu_torch.observability.sketch import QuantileSketch
        insts = self.instances(window, now)
        if not insts:
            return NAN
        q = _parse_q(fn)
        if fn in ("delta", "rate") or q is not None:
            # sum of per-member windowed deltas, each reset-detected
            # against its OWN history
            deltas = []
            sketches = []
            span = 0.0
            for inst in insts:
                pts = self.points(name, labels, inst, window, now)
                if len(pts) >= 2:
                    span = max(span, pts[-1][0] - pts[0][0])
                if q is not None:
                    snaps = [p for _, k, p in pts if k == "summary"]
                    if len(snaps) >= 2:
                        counts = [int(s.get("count", 0)) for s in snaps]
                        ok = all(b >= a
                                 for a, b in zip(counts, counts[1:]))
                        d = sketch_delta(snaps[0] if ok else None,
                                         snaps[-1])
                        if d is not None and int(d.get("count", 0)) > 0:
                            sketches.append(d)
                else:
                    d = self._apply("delta", pts)
                    if not math.isnan(d):
                        deltas.append(d)
            if q is not None:
                merged = None
                for snap in sketches:
                    sk = QuantileSketch.from_snapshot(snap)
                    if merged is None:
                        merged = sk
                    else:
                        try:
                            merged.merge(sk)
                        except (ValueError, KeyError):
                            pass    # alpha-mismatched member: skip
                if merged is None or merged.count == 0:
                    return NAN
                return float(merged.quantile(q))
            if not deltas:
                return NAN
            total = sum(deltas)
            if fn == "rate":
                return total / span if span > 0 else NAN
            return total
        # gauge stats over the per-sample cross-member sums
        sums: List[Tuple[float, float]] = []
        for ts, docs in self._window(window, now):
            vals = []
            for inst in insts:
                doc = docs.get(inst)
                got = _extract(doc, name, labels) if doc else None
                if got is not None and got[0] not in ("summary",
                                                      "histogram"):
                    vals.append(float(got[1]))
                elif got is not None and got[0] == "histogram":
                    vals.append(float(got[1]["count"]))
            if vals:
                sums.append((ts, sum(vals)))
        return gauge_stats([v for _, v in sums]).get(fn, NAN)

    def timeline(self, name: str,
                 labels: Optional[Dict[str, str]] = None,
                 window: Optional[float] = None,
                 now: Optional[float] = None) -> dict:
        """Per-member + merged series over time (the ``/fleet/timeline``
        body): scalar values for counters/gauges, observation counts
        for histograms/sketches. Merged points sum the members present
        at each sample — departed/stale members stop contributing the
        moment they leave the scrape set."""
        win = self._window(window, now)
        per: Dict[str, List[List[float]]] = {}
        merged: List[List[float]] = []
        for ts, docs in win:
            total = 0.0
            seen = False
            for inst in sorted(docs):
                got = _extract(docs[inst], name, labels)
                if got is None:
                    continue
                kind, payload = got
                if kind == "summary":
                    val = float(payload.get("count", 0))
                elif kind == "histogram":
                    val = float(payload["count"])
                else:
                    val = float(payload)
                per.setdefault(inst, []).append([ts, val])
                total += val
                seen = True
            if seen:
                merged.append([ts, total])
        return {"series": name, "labels": labels or {},
                "instances": per, "merged": merged,
                "samples": len(win),
                "from": win[0][0] if win else None,
                "to": win[-1][0] if win else None}

    def status(self) -> dict:
        with self._lock:
            n = len(self._samples)
            t0 = self._samples[0][0] if self._samples else None
            t1 = self._samples[-1][0] if self._samples else None
        return {"interval_s": self.interval,
                "retention_s": self.retention,
                "samples": n, "evicted": self.evicted,
                "sample_overhead_us": round(self.last_overhead_us, 1),
                "oldest_ts": t0, "newest_ts": t1,
                "instances": self.instances()}


# ---------------------------------------------------------------------------
# module lifecycle (the structural-absence surface)
# ---------------------------------------------------------------------------

def store() -> Optional[TimeSeriesStore]:
    """The live store, or None when the plane never started (the
    structural-absence invariant tests assert on)."""
    return _store


def _get_store() -> TimeSeriesStore:
    global _store
    with _lock:
        if _store is None:
            _store = TimeSeriesStore()
        return _store


def _instruments() -> Optional[Dict[str, Any]]:
    global _ins
    from bigdl_tpu_torch import observability as obs
    if not obs.enabled():
        return None
    if _ins is None:
        _ins = {
            "samples": obs.counter(
                "bigdl_timeseries_samples_total",
                "Registry snapshots taken into the time-series ring"),
            "overhead": obs.gauge(
                "bigdl_timeseries_sample_overhead_us",
                "Host microseconds the last time-series sample cost"),
        }
    return _ins


def acquire() -> Optional[TimeSeriesStore]:
    """Refcounted start: every serving surface (engine, worker, router)
    acquires on start when the plane is enabled and
    releases on stop — the sampler thread runs while anyone needs it.
    Returns None (and builds nothing) when the gate is off."""
    global _refs
    if not enabled:
        return None
    st = _get_store()
    with _lock:
        _refs += 1
    st.start()
    from bigdl_tpu_torch.observability import alerts
    alerts.ensure_engine(st)
    return st


def release():
    global _refs
    with _lock:
        if _refs > 0:
            _refs -= 1
        st = _store if _refs == 0 else None
    if st is not None:
        st.stop()


def sample_now(now: Optional[float] = None) -> Optional[float]:
    """Manual tick of the live store (the tests' fake clock)."""
    st = _store
    if st is None:
        return None
    return st.sample_now(now)


def attach_collector(collector):
    """Ride a federation collector's scrape cache for fleet timelines.
    No-op when the gate is off."""
    if enabled:
        _get_store().attach_collector(collector)


def detach_collector(collector):
    st = _store
    if st is not None:
        st.detach_collector(collector)


def slo_burn(slo: str, scope: str, window: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
    """Windowed SLO burn — violated/classified over the store's window
    (``bigdl.observability.timeseries.slo.window`` seconds) instead of
    slo.py's last-N-requests deque. None when the plane is off or the
    store has no usable window yet (callers fall back to the deque);
    0.0 on a warm store with no traffic in the window."""
    if not enabled:
        return None
    st = _store
    if st is None:
        return None
    if window is None:
        window = conf.get_float(
            "bigdl.observability.timeseries.slo.window", 300.0)
    bad = st.query("bigdl_slo_requests_total", "delta", window,
                   labels={"slo": slo, "verdict": "violated",
                           "scope": scope}, now=now)
    ok = st.query("bigdl_slo_requests_total", "delta", window,
                  labels={"slo": slo, "verdict": "ok", "scope": scope},
                  now=now)
    if math.isnan(bad) and math.isnan(ok):
        return None if len(st) < 2 else 0.0
    bad = 0.0 if math.isnan(bad) else bad
    ok = 0.0 if math.isnan(ok) else ok
    total = bad + ok
    return (bad / total) if total > 0 else 0.0


def reset():
    """Stop the sampler and drop the ring + cached instruments — test
    isolation (wired into ``obs.reset()``)."""
    global _store, _refs, _ins
    with _lock:
        st = _store
        _store = None
        _refs = 0
        _ins = None
    if st is not None:
        st.stop()


# ---------------------------------------------------------------------------
# HTTP surface (shared helper: see tracing/flight.debug_endpoint)
# ---------------------------------------------------------------------------

def parse_series(expr: str) -> Tuple[str, Dict[str, str]]:
    """``name`` or ``name{label=value,label2=value2}`` (values may be
    single- or double-quoted) -> (name, labels)."""
    expr = expr.strip()
    if "{" not in expr:
        return expr, {}
    name, rest = expr.split("{", 1)
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if not part.strip():
            continue
        if "=" not in part:
            raise ValueError(f"bad series selector {expr!r}")
        k, v = part.split("=", 1)
        labels[k.strip()] = v.strip().strip("'\"")
    return name.strip(), labels


def _finite(v: Optional[float]):
    """NaN/inf -> None: the HTTP bodies stay strict-JSON while the
    Python API keeps the NaN empty-window contract."""
    if v is None or not isinstance(v, float) or math.isfinite(v):
        return v
    return None


def debug_endpoint(path: str):
    """Serve the time-series GET endpoints for any HTTP handler.
    Returns ``(status, jsonable)`` for paths this module owns —
    including the 404 arms when the plane is disabled — or ``None``
    for paths it does not serve. Keeps the worker's and the router's
    surfaces identical."""
    parts = urlsplit(path)
    p = parts.path
    if p not in ("/metrics/query", "/fleet/timeline"):
        return None
    if not enabled:
        return 404, {"error": "timeseries disabled",
                     "gate": "bigdl.observability.timeseries.enabled"}
    st = _store
    q = parse_qs(parts.query)

    def _one(key, default=None):
        return (q.get(key) or [default])[0]

    expr = _one("series")
    if not expr:
        return 400, {"error": "series= is required "
                              "(name or name{label=value,...})"}
    try:
        name, labels = parse_series(expr)
    except ValueError as e:
        return 400, {"error": str(e)}
    try:
        window = float(_one("window")) if _one("window") else None
    except (TypeError, ValueError):
        return 400, {"error": "window= must be seconds"}
    if p == "/metrics/query":
        fn = _one("fn", "last")
        instance = _one("instance")
        if st is None:
            return 200, {"series": expr, "fn": fn, "window": window,
                         "value": None, "samples": 0}
        val = st.query(name, fn=fn, window=window, labels=labels,
                       instance=instance)
        pts = st.points(name, labels,
                        None if instance == "*" else instance, window)
        return 200, {"series": expr, "fn": fn, "window": window,
                     "instance": instance or st.local_instance(),
                     "value": _finite(val), "samples": len(pts),
                     "from": pts[0][0] if pts else None,
                     "to": pts[-1][0] if pts else None}
    if st is None:
        return 200, {"series": name, "labels": labels, "instances": {},
                     "merged": [], "samples": 0}
    return 200, st.timeline(name, labels=labels, window=window)


__all__ = [
    "TimeSeriesStore", "WindowedCounter", "acquire", "attach_collector",
    "counter_delta", "counter_rate", "debug_endpoint",
    "detach_collector", "enabled", "gauge_stats", "histogram_delta",
    "parse_series", "release", "reset", "sample_now", "sketch_delta",
    "sketch_window", "slo_burn", "store",
]
