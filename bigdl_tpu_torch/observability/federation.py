"""Cross-worker metric federation — the port of
``bigdl_tpu/observability/federation.py``.

The serving stack is a fleet (prefill / decode worker pools behind an
:class:`~bigdl_tpu_torch.llm.worker.LLMRouter`), but every process
renders only its own registry. This module is the aggregation plane:

- :func:`registry_snapshot` — one registry's FULL state as a JSON-able
  document (counters / gauges as values, histograms as bucket arrays,
  sketches as their lossless :meth:`~bigdl_tpu_torch.observability.
  sketch.QuantileSketch.to_snapshot` dicts), with the live roofline
  table under ``"roofline"`` when the flight recorder is on. Served by
  every member's ``GET /metrics/snapshot``.
- :func:`merge_snapshots` — the label-aware fleet merge: **counters
  sum** per (name, label values); **gauges gain an ``instance``
  label** (summing a queue-depth gauge across workers is a lie);
  **histograms with equal bounds sum** bucket-wise (mismatched bounds
  fall back to instance-labeled passthrough); **sketches merge
  losslessly** (same gamma; a mismatch falls back to instance-labeled
  passthrough rather than voiding the error bound).
- :func:`render_merged` — Prometheus text of a merged document, so the
  fleet view scrapes exactly like a single process.
- :class:`FederationCollector` — the background poller the router
  embeds: one daemon thread sweeps every member's ``/metrics/snapshot``
  each ``bigdl.observability.federation.interval`` seconds and caches
  the result. A failed scrape (the ``federation.scrape`` fault site
  fires around each member fetch) marks that instance **stale** — its
  last-known snapshot keeps serving, flagged in ``/fleet/status`` —
  and never blocks a render: the serving thread only reads the cache.
- :class:`SnapshotServer` — a minimal HTTP surface (``/metrics/snapshot``
  + ``/metrics``) for processes that have none.

The document format, the merge and the exposition are the JAX
package's byte for byte, so a mixed fleet (a port router over JAX
workers, or the reverse) merges. Everything is off by default behind
``bigdl.observability.federation``: disabled means no collector thread,
no snapshot endpoints (404), no ``bigdl_federation_*`` series. Host
code only: the collector touches HTTP and host state, never an engine.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.observability.metrics import (
    SUMMARY_QUANTILES, _format_value, _HistogramChild,
    _labels_suffix, _SketchChild)
from bigdl_tpu_torch.observability.sketch import QuantileSketch


def federation_enabled(override: Optional[bool] = None) -> bool:
    """The one gate every surface checks (``bigdl.observability.
    federation``, default off)."""
    if override is not None:
        return bool(override)
    from bigdl_tpu_torch.utils.conf import conf
    return conf.get_bool("bigdl.observability.federation", False)


# ---------------------------------------------------------------------------
# snapshot (the wire format)
# ---------------------------------------------------------------------------

def registry_snapshot(registry=None, instance: str = "") -> dict:
    """JSON-able full state of ``registry`` (default: the process
    registry). The document every ``GET /metrics/snapshot`` returns and
    every merge consumes."""
    if registry is None:
        # the process registry must carry the same self-describing
        # series a direct /metrics render mints (bigdl_build_info,
        # process_start_time_seconds) — enabling federation must not
        # drop them from the fleet scrape
        obs._ensure_standard_series()
        registry = obs.REGISTRY
    metrics: List[dict] = []
    for m in registry.collect():
        series: List[dict] = []
        for key, child in sorted(m.children()):
            entry: Dict[str, Any] = {"labels": list(key)}
            if isinstance(child, _HistogramChild):
                cum, total, count = child.snapshot()
                entry.update({"bounds": list(m.buckets),
                              "cum": cum, "sum": total, "count": count})
            elif isinstance(child, _SketchChild):
                entry["sketch"] = child.to_snapshot()
            else:
                entry["value"] = child.value
            series.append(entry)
        metrics.append({"name": m.name, "kind": m.kind, "help": m.help,
                        "labelnames": list(m.labelnames),
                        "series": series})
    doc = {"instance": instance, "ts": time.time(), "metrics": metrics}
    from bigdl_tpu_torch.observability import flight, utilization
    if flight.enabled:
        # live roofline attribution: the per-program table
        # rides the snapshot; merge_snapshots only reads "metrics", so
        # fleet merging tolerates the extra key
        roof = utilization.snapshot()
        if roof["programs"]:
            doc["roofline"] = roof
    return doc


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def merge_snapshots(snapshots: Dict[str, dict]) -> dict:
    """Label-aware merge of ``{instance: snapshot_doc}`` into one
    fleet-level document of the same shape (instance ``""``)."""
    # (name) -> {"kind", "help", "labelnames", per-kind accumulator}
    merged: Dict[str, dict] = {}
    order: List[str] = []

    def _meta(mdoc, labelnames):
        name = mdoc["name"]
        meta = merged.get(name)
        if meta is None:
            meta = merged[name] = {
                "kind": mdoc["kind"], "help": mdoc.get("help", ""),
                "labelnames": list(labelnames), "series": {}}
            order.append(name)
        return meta

    for instance in sorted(snapshots):
        doc = snapshots[instance]
        for mdoc in doc.get("metrics", []):
            kind = mdoc["kind"]
            lnames = list(mdoc.get("labelnames", []))
            if kind == "gauge":
                # per-instance series: aggregating pages-free or queue
                # depth by summing would manufacture a machine that
                # does not exist
                meta = _meta(mdoc, lnames + ["instance"])
                for s in mdoc.get("series", []):
                    key = tuple(s.get("labels", [])) + (instance,)
                    meta["series"][key] = {"value": s.get("value", 0.0)}
                continue
            meta = _meta(mdoc, lnames)
            for s in mdoc.get("series", []):
                key = tuple(s.get("labels", []))
                acc = meta["series"].get(key)
                if kind == "counter":
                    val = float(s.get("value", 0.0))
                    if acc is None:
                        meta["series"][key] = {"value": val}
                    else:
                        acc["value"] += val
                elif kind == "histogram":
                    _merge_histogram(meta, key, s, instance)
                elif kind == "summary":
                    _merge_sketch(meta, key, s, instance)
                else:           # untyped passthrough, instance-labeled
                    meta["series"][key + (instance,)] = \
                        {"value": s.get("value", 0.0)}
                    meta["labelnames"] = lnames + ["instance"]
    out_metrics = []
    for name in sorted(order):
        meta = merged[name]
        series = []
        for key in sorted(meta["series"]):
            entry = dict(meta["series"][key])
            entry["labels"] = list(key)
            if "_sketch_obj" in entry:
                entry["sketch"] = entry.pop("_sketch_obj").to_snapshot()
            series.append(entry)
        out_metrics.append({"name": name, "kind": meta["kind"],
                            "help": meta["help"],
                            "labelnames": meta["labelnames"],
                            "series": series})
    return {"instance": "", "ts": time.time(), "metrics": out_metrics}


def _merge_histogram(meta: dict, key: tuple, s: dict, instance: str):
    acc = meta["series"].get(key)
    bounds = list(s.get("bounds", []))
    if acc is None:
        meta["series"][key] = {
            "bounds": bounds, "cum": list(s.get("cum", [])),
            "sum": float(s.get("sum", 0.0)),
            "count": int(s.get("count", 0))}
        return
    if acc.get("bounds") != bounds or \
            len(acc.get("cum", [])) != len(s.get("cum", [])):
        # mismatched layouts cannot sum honestly: keep the newcomer as
        # its own instance-labeled series
        meta["series"][key + (f"!{instance}",)] = {
            "bounds": bounds, "cum": list(s.get("cum", [])),
            "sum": float(s.get("sum", 0.0)),
            "count": int(s.get("count", 0))}
        return
    acc["cum"] = [a + b for a, b in zip(acc["cum"], s.get("cum", []))]
    acc["sum"] += float(s.get("sum", 0.0))
    acc["count"] += int(s.get("count", 0))


def _merge_sketch(meta: dict, key: tuple, s: dict, instance: str):
    acc = meta["series"].get(key)
    snap = s.get("sketch") or {}
    sk = QuantileSketch.from_snapshot(snap)
    if acc is None:
        meta["series"][key] = {"_sketch_obj": sk}
        return
    try:
        acc["_sketch_obj"].merge(sk)
    except (ValueError, KeyError):
        meta["series"][key + (f"!{instance}",)] = {"_sketch_obj": sk}


def render_merged(doc: dict) -> str:
    """Prometheus text exposition of a (merged or single) snapshot
    document — the fleet ``GET /metrics`` body."""
    lines: List[str] = []
    for mdoc in doc.get("metrics", []):
        name = mdoc["name"]
        lnames = list(mdoc.get("labelnames", []))
        lines.append(f"# HELP {name} " +
                     mdoc.get("help", "").replace("\\", "\\\\")
                     .replace("\n", "\\n"))
        lines.append(f"# TYPE {name} {mdoc['kind']}")
        for s in mdoc.get("series", []):
            key = list(s.get("labels", []))
            # histogram-mismatch fallbacks carry a trailing !instance
            # pseudo-label; render it as an instance label
            names = list(lnames)
            while len(key) > len(names):
                names.append("instance")
            key = [k.lstrip("!") if isinstance(k, str) else k
                   for k in key]
            if "cum" in s:
                bounds = [_format_value(b) for b in s["bounds"]] \
                    + ["+Inf"]
                for bound, c in zip(bounds, s["cum"]):
                    suffix = _labels_suffix(names, key,
                                            extra=[("le", bound)])
                    lines.append(f"{name}_bucket{suffix} {c}")
                suffix = _labels_suffix(names, key)
                lines.append(f"{name}_sum{suffix} "
                             f"{_format_value(s['sum'])}")
                lines.append(f"{name}_count{suffix} {s['count']}")
            elif "sketch" in s:
                sk = QuantileSketch.from_snapshot(s["sketch"])
                for q in SUMMARY_QUANTILES:
                    suffix = _labels_suffix(
                        names, key, extra=[("quantile",
                                            _format_value(q))])
                    v = sk.quantile(q)
                    lines.append(
                        f"{name}{suffix} "
                        f"{_format_value(v) if v is not None else 'NaN'}")
                suffix = _labels_suffix(names, key)
                lines.append(f"{name}_sum{suffix} "
                             f"{_format_value(sk.sum)}")
                lines.append(f"{name}_count{suffix} {sk.count}")
            else:
                suffix = _labels_suffix(names, key)
                lines.append(f"{name}{suffix} "
                             f"{_format_value(s.get('value', 0.0))}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------

def _fetch_snapshot(addr: Tuple[str, int], timeout: float) -> dict:
    import http.client
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    try:
        conn.request("GET", "/metrics/snapshot")
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status != 200:
            raise RuntimeError(
                f"{addr[0]}:{addr[1]}/metrics/snapshot answered "
                f"{resp.status}")
        return json.loads(raw.decode())
    finally:
        conn.close()


class FederationCollector:
    """Background poller + merge cache. ``targets_fn`` returns the live
    ``[(instance_name, (host, port)), ...]`` membership snapshot (pools
    mutate; the collector re-reads every sweep). ``include_self``
    labels the embedding process's own registry into the fleet view
    without a loopback scrape."""

    THREAD_NAME = "bigdl-federation-collector"

    def __init__(self, targets_fn: Callable[[], List[Tuple[str, Any]]],
                 interval: Optional[float] = None, timeout: float = 2.0,
                 include_self: Optional[str] = None):
        from bigdl_tpu_torch.utils.conf import conf
        self._targets_fn = targets_fn
        self.interval = (interval if interval is not None else
                         conf.get_float(
                             "bigdl.observability.federation.interval",
                             2.0))
        self.timeout = timeout
        self.include_self = include_self
        self._lock = threading.Lock()
        # instance -> {"snapshot", "ts", "stale", "failures", "scrapes"}
        self._members: Dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ins = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FederationCollector":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=self.THREAD_NAME, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 2.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.collect_now()
            except Exception:   # noqa: BLE001 — the collector never dies
                pass

    # -- scraping ------------------------------------------------------------
    def collect_now(self):
        """One synchronous sweep (also the tests' fake clock). Scrape
        failures mark the member stale and keep its last snapshot —
        they NEVER propagate to the render path."""
        t0 = time.time()
        targets = list(self._targets_fn())
        live = set()
        for name, addr in targets:
            if self._stop.is_set():
                return
            live.add(name)
            try:
                # the fault site: a seeded raise here is a dead/slow
                # member — the contract is stale-marking, not a stall
                reliability.inject("federation.scrape")
                snap = _fetch_snapshot(tuple(addr), self.timeout)
            except Exception:   # noqa: BLE001 — dead member = stale
                with self._lock:
                    ent = self._members.setdefault(
                        name, {"snapshot": None, "ts": 0.0,
                               "stale": True, "failures": 0,
                               "scrapes": 0, "address": list(addr)})
                    ent["stale"] = True
                    ent["failures"] += 1
                    ent["address"] = list(addr)
                self._count_scrape("error")
                continue
            with self._lock:
                ent = self._members.setdefault(
                    name, {"snapshot": None, "ts": 0.0, "stale": False,
                           "failures": 0, "scrapes": 0,
                           "address": list(addr)})
                ent.update({"snapshot": snap, "ts": time.time(),
                            "stale": False, "address": list(addr)})
                ent["scrapes"] += 1
            self._count_scrape("ok")
        with self._lock:
            # members that left the pool stop being rendered at all
            for gone in set(self._members) - live:
                self._members.pop(gone, None)
            stale = sum(1 for e in self._members.values() if e["stale"])
            n = len(self._members)
        if obs.enabled():
            obs.gauge("bigdl_federation_members",
                      "Members the fleet collector is scraping").set(n)
            obs.gauge("bigdl_federation_stale_instances",
                      "Members whose last /metrics/snapshot scrape "
                      "failed (serving last-known state)").set(stale)
            obs.add_complete("federation/scrape", t0, time.time() - t0,
                             stage="federation", members=n, stale=stale)

    def _count_scrape(self, outcome: str):
        if obs.enabled():
            obs.counter(
                "bigdl_federation_scrapes_total",
                "Member snapshot scrapes by outcome",
                labelnames=("outcome",)).labels(outcome=outcome).inc()

    # -- views ---------------------------------------------------------------
    def snapshots(self) -> Dict[str, dict]:
        """Last-known member snapshots (stale members included — last
        state beats a hole in the fleet view), plus the embedding
        process's own registry when ``include_self`` names it."""
        with self._lock:
            out = {name: ent["snapshot"]
                   for name, ent in self._members.items()
                   if ent["snapshot"] is not None}
        if self.include_self is not None:
            out[self.include_self] = registry_snapshot(
                instance=self.include_self)
        return out

    def stale_instances(self) -> set:
        """Members whose last scrape failed (serving last-known
        snapshots). The time-series store excludes them at sample time
        so merged windows only aggregate live members."""
        with self._lock:
            return {name for name, ent in self._members.items()
                    if ent["stale"]}

    def merged(self) -> dict:
        return merge_snapshots(self.snapshots())

    def render(self) -> str:
        return render_merged(self.merged())

    def status(self) -> dict:
        """The ``GET /fleet/status`` body."""
        now = time.time()
        with self._lock:
            members = {
                name: {
                    "stale": ent["stale"],
                    "scrapes": ent["scrapes"],
                    "failures": ent["failures"],
                    # the scrape target, so tooling can re-fetch
                    # snapshots even when the member NAME is not an
                    # address
                    "address": list(ent.get("address") or []),
                    "last_scrape_age_s": (round(now - ent["ts"], 3)
                                          if ent["ts"] else None),
                    "series": (sum(len(m.get("series", []))
                                   for m in ent["snapshot"]["metrics"])
                               if ent["snapshot"] else 0),
                }
                for name, ent in sorted(self._members.items())}
        return {"interval_s": self.interval,
                "include_self": self.include_self,
                "members": members,
                "stale": sum(1 for m in members.values() if m["stale"])}


# ---------------------------------------------------------------------------
# snapshot server (for processes with no HTTP surface of their own)
# ---------------------------------------------------------------------------

class SnapshotServer:
    """Tiny ``/metrics/snapshot`` + ``/metrics`` listener for member
    processes that have no serving surface (a batch job, a trainer).
    Constructed only when federation is enabled — the disabled mode has
    no thread and no socket."""

    def __init__(self, instance: str = "", host: str = "127.0.0.1",
                 port: int = 0):
        import http.server
        instance_name = instance

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/metrics/snapshot":
                    body = json.dumps(registry_snapshot(
                        instance=instance_name)).encode()
                    ctype = "application/json"
                elif self.path == "/metrics":
                    body = obs.render().encode()
                    ctype = obs.CONTENT_TYPE
                else:
                    body = b'{"error": "unknown path"}'
                    self.send_response(404)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        import http.server as _hs
        self._httpd = _hs.ThreadingHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SnapshotServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="bigdl-federation-snapshot", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()
