"""Fleet telemetry report: the per-backend and merged view of a
federated metric plane — the port of the JAX package's
``tools/fleet_report.py``.

- **Live fleet**: point it at a federation-enabled router — it fetches
  ``/fleet/status`` plus each member's ``/metrics/snapshot`` and prints
  per-instance and merged tables::

      python -m bigdl_tpu_torch.tools.fleet_report --url 127.0.0.1:8000

- **Offline snapshots**: merge saved ``/metrics/snapshot`` JSON
  documents (one file per member)::

      python -m bigdl_tpu_torch.tools.fleet_report snapA.json snapB.json \\
          [--json]

- **Fleet timeline**: per-member + merged series over time from a
  time-series-enabled router's ``/fleet/timeline``::

      python -m bigdl_tpu_torch.tools.fleet_report \\
          --timeline 127.0.0.1:8000 \\
          --series bigdl_llm_decode_tokens_total [--window 300]

- **Library** (``run_fleet_micro``): two decode workers behind a
  failover router with federation + SLO accounting on, a small request
  mix, the merged sketch percentiles (``ttft_p50/p95/p99_ms``,
  ``itl_p99_ms``) and a counter-additivity check (``--micro [--device
  cpu]``).

The percentile columns come from the merged quantile sketches — exact
to the sketch's stated relative-error bound, not bucket-interpolated.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Tuple

#: sketch series the percentile tables highlight, in render order
_LATENCY_SKETCHES = (
    "bigdl_router_ttft_seconds", "bigdl_router_itl_seconds",
    "bigdl_llm_ttft_seconds", "bigdl_llm_itl_seconds")


def _http_get(addr: Tuple[str, int], path: str, timeout: float = 10.0):
    import http.client
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw
    finally:
        conn.close()


def sketch_rows(snapshots: Dict[str, dict]) -> List[List]:
    """Per-instance AND merged percentile rows for every sketch series
    found in ``snapshots`` ({instance: snapshot doc})."""
    from bigdl_tpu_torch.observability.federation import merge_snapshots
    from bigdl_tpu_torch.observability.sketch import QuantileSketch

    rows: List[List] = []

    def add_rows(instance: str, doc: dict):
        for mdoc in doc.get("metrics", []):
            if mdoc.get("kind") != "summary":
                continue
            for s in mdoc.get("series", []):
                if "sketch" not in s:
                    continue
                sk = QuantileSketch.from_snapshot(s["sketch"])
                if sk.count == 0:
                    continue
                label = ",".join(str(v) for v in s.get("labels", []))
                rows.append([
                    instance, mdoc["name"] + (f"{{{label}}}" if label
                                              else ""),
                    sk.count,
                    _ms(sk.quantile(0.5)), _ms(sk.quantile(0.9)),
                    _ms(sk.quantile(0.95)), _ms(sk.quantile(0.99)),
                    _ms(sk.max)])

    for instance in sorted(snapshots):
        add_rows(instance, snapshots[instance])
    add_rows("MERGED", merge_snapshots(snapshots))
    # stable, sketch-catalog-first ordering
    prio = {n: i for i, n in enumerate(_LATENCY_SKETCHES)}
    rows.sort(key=lambda r: (r[0] != "MERGED",
                             prio.get(r[1].split("{")[0], 99), r[0]))
    return rows


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1000.0, 3)


def counter_table(snapshots: Dict[str, dict],
                  names: Optional[List[str]] = None) -> List[List]:
    """Per-instance + summed rows for counters (the merge-correctness
    view: MERGED must equal the per-instance sum)."""
    from bigdl_tpu_torch.observability.federation import merge_snapshots
    per: Dict[str, Dict[str, float]] = {}
    for instance, doc in snapshots.items():
        for mdoc in doc.get("metrics", []):
            if mdoc.get("kind") != "counter":
                continue
            if names and mdoc["name"] not in names:
                continue
            total = sum(float(s.get("value", 0.0))
                        for s in mdoc.get("series", []))
            per.setdefault(mdoc["name"], {})[instance] = total
    merged = merge_snapshots(snapshots)
    fed: Dict[str, float] = {}
    for mdoc in merged.get("metrics", []):
        if mdoc.get("kind") == "counter":
            fed[mdoc["name"]] = sum(float(s.get("value", 0.0))
                                    for s in mdoc.get("series", []))
    rows = []
    for name in sorted(per):
        inst = per[name]
        rows.append([name, round(sum(inst.values()), 6),
                     round(fed.get(name, 0.0), 6),
                     " ".join(f"{i}={v:g}"
                              for i, v in sorted(inst.items()))])
    return rows


def _print_table(title: str, header: List[str], rows: List[List]):
    def fmt(v):
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.6g}"
        return str(v)
    rows = [[fmt(c) for c in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(header)]
    print(f"\n== {title} ==")
    print("  ".join(h.ljust(w) for h, w in zip(header, widths)))
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))


def sketch_dicts(snapshots: Dict[str, dict]) -> List[dict]:
    """The sketch percentile rows as dicts — shared by this report and
    ``telemetry_report --fleet`` so the column mapping lives once."""
    return [{"instance": r[0], "series": r[1], "count": r[2],
             "p50_ms": r[3], "p90_ms": r[4], "p95_ms": r[5],
             "p99_ms": r[6], "max_ms": r[7]}
            for r in sketch_rows(snapshots)]


def load_snapshots(paths: List[str]) -> Dict[str, dict]:
    """Saved ``/metrics/snapshot`` docs keyed by their embedded
    instance name (file basename when absent)."""
    snapshots: Dict[str, dict] = {}
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        snapshots[doc.get("instance") or os.path.basename(p)] = doc
    return snapshots


def report(snapshots: Dict[str, dict], as_json: bool = False,
           status: Optional[dict] = None) -> dict:
    out = {
        "instances": sorted(snapshots),
        "sketches": sketch_dicts(snapshots),
        "counters": [
            {"name": r[0], "sum": r[1], "federated": r[2], "per": r[3]}
            for r in counter_table(snapshots)],
    }
    if status is not None:
        out["fleet_status"] = status
    if as_json:
        print(json.dumps(out))
        return out
    if status is not None:
        _print_table(
            "fleet members", ["instance", "stale", "scrapes",
                              "failures", "age_s"],
            [[n, m["stale"], m["scrapes"], m["failures"],
              m["last_scrape_age_s"]]
             for n, m in sorted(status.get("members", {}).items())])
    _print_table(
        "sketch percentiles (ms)",
        ["instance", "series", "n", "p50", "p90", "p95", "p99", "max"],
        sketch_rows(snapshots))
    _print_table(
        "counters (federated must equal the per-instance sum)",
        ["counter", "sum", "federated", "per-instance"],
        counter_table(snapshots))
    return out


# ---------------------------------------------------------------------------
# a two-worker fleet, driven and reported
# ---------------------------------------------------------------------------

def run_fleet_micro(n_requests: int = 6, new_tokens: int = 4, model=None,
                    device=None) -> Dict:
    """Two decode workers behind a federation+SLO failover router;
    returns merged sketch percentiles and the counter-additivity
    verdict. ``model`` (both engines' shared weights) defaults to a tiny
    f32 Llama on ``device`` (``None`` = the GPU)."""
    import numpy as np

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker
    from bigdl_tpu_torch.observability.federation import merge_snapshots
    from bigdl_tpu_torch.observability.sketch import QuantileSketch

    if not obs.enabled():
        return {"skipped": "observability disabled"}
    if model is None:
        from bigdl_tpu_torch.llm.chaos import tiny_model
        model = tiny_model(device)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 250, 8 + 2 * (j % 3)).astype(np.int32)
               for j in range(n_requests)]
    # sketch counts are reported as DELTAS: the process registry is
    # shared with whatever ran before this block (e.g. the chaos storm)
    base_ttft = obs.REGISTRY.sample_value(
        "bigdl_router_ttft_seconds") or 0
    base_itl = obs.REGISTRY.sample_value(
        "bigdl_router_itl_seconds") or 0
    s1 = LLMServer(model, max_batch=2, max_seq_len=64, slo=True,
                   device=model.device).start()
    s2 = LLMServer(model, max_batch=2, max_seq_len=64, slo=True,
                   device=model.device).start()
    w1 = LLMWorker(s1, role="decode", federation=True).start()
    w2 = LLMWorker(s2, role="decode", federation=True).start()
    router = LLMRouter([], [w1.address, w2.address], failover=True,
                       slo=True, federation=True,
                       start_prober=False).start()
    try:
        import http.client

        def post(addr, path, body):
            conn = http.client.HTTPConnection(*addr, timeout=120)
            try:
                conn.request("POST", path, json.dumps(body),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                return r.status, json.loads(r.read().decode())
            finally:
                conn.close()

        # warm both engines on every prompt length so compile time
        # doesn't pollute the tail percentiles
        lengths = sorted({len(p) for p in prompts})
        for srv in (s1, s2):
            for n in lengths:
                srv.submit(prompts[0][:1].repeat(n),
                           max_new_tokens=1).get(timeout=600)
        ok = 0
        for p in prompts:
            st, _ = post(router.address, "/worker_generate",
                         {"prompt_ids": [int(t) for t in p],
                          "max_new_tokens": new_tokens})
            ok += (st == 200)
        router._collector.collect_now()
        snaps = {name: snap
                 for name, snap in router._collector.snapshots().items()
                 if name != "router"}
        merged = merge_snapshots(router._collector.snapshots())
        out: Dict = {"requests": n_requests, "succeeded": ok,
                     "members": sorted(snaps)}
        # merged percentiles from the fleet view. Note: colocated test
        # members share one process registry, so merged COUNTS are
        # N_members × the true count — quantiles are unaffected
        # (merging copies of a sketch preserves its distribution); the
        # honest per-request counts below come from the local registry
        for mdoc in merged.get("metrics", []):
            if mdoc["name"] == "bigdl_router_ttft_seconds":
                for s in mdoc["series"]:
                    sk = QuantileSketch.from_snapshot(s["sketch"])
                    out["ttft_p50_ms"] = _ms(sk.quantile(0.5))
                    out["ttft_p95_ms"] = _ms(sk.quantile(0.95))
                    out["ttft_p99_ms"] = _ms(sk.quantile(0.99))
            if mdoc["name"] == "bigdl_router_itl_seconds":
                for s in mdoc["series"]:
                    sk = QuantileSketch.from_snapshot(s["sketch"])
                    out["itl_p99_ms"] = _ms(sk.quantile(0.99))
        out["ttft_count"] = (obs.REGISTRY.sample_value(
            "bigdl_router_ttft_seconds") or 0) - base_ttft
        out["itl_count"] = (obs.REGISTRY.sample_value(
            "bigdl_router_itl_seconds") or 0) - base_itl
        # counter additivity: the federated value must equal the sum
        # of what the members reported
        name = "bigdl_llm_decode_tokens_total"
        member_sum = 0.0
        for snap in snaps.values():
            for mdoc in snap.get("metrics", []):
                if mdoc["name"] == name:
                    member_sum += sum(float(s.get("value", 0.0))
                                      for s in mdoc.get("series", []))
        fed_members = merge_snapshots(snaps)
        fed = 0.0
        for mdoc in fed_members.get("metrics", []):
            if mdoc["name"] == name:
                fed = sum(float(s.get("value", 0.0))
                          for s in mdoc.get("series", []))
        out["counter_additive"] = abs(fed - member_sum) < 1e-9
        out["slo"] = (router._slo.status()
                      if router._slo is not None else None)
        return out
    finally:
        router.stop()
        w1.stop()
        w2.stop()
        s1.stop()
        s2.stop()


def fetch_timeline(addr: Tuple[str, int], series: str,
                   window: Optional[float] = None) -> dict:
    """One ``GET /fleet/timeline`` roundtrip → the timeline document.
    Raises with the body's error on non-200 (404 names the gate)."""
    from urllib.parse import quote
    path = f"/fleet/timeline?series={quote(series, safe='')}"
    if window is not None:
        path += f"&window={window}"
    st, raw = _http_get(addr, path)
    body = json.loads(raw.decode() or "{}")
    if st != 200:
        raise RuntimeError(
            f"{addr[0]}:{addr[1]}{path} answered {st}: "
            f"{body.get('error', '?')} — is "
            "bigdl.observability.timeseries.enabled on?")
    return body


#: the sparkline's levels (``tools/telemetry_report.py``'s, kept here)
SPARK_CHARS = "\u2581\u2582\u2583\u2584\u2585\u2586\u2587\u2588"


def sparkline(values: List[Optional[float]], width: int = 40) -> str:
    """Terminal sparkline of the last ``width`` values; ``None`` (no
    data in the window yet) renders as a gap."""
    vals = list(values)[-width:]
    known = [v for v in vals if v is not None]
    if not known:
        return " " * len(vals)
    lo, hi = min(known), max(known)
    span = (hi - lo) or 1.0
    out = []
    for v in vals:
        if v is None:
            out.append(" ")
        else:
            idx = int((v - lo) / span * (len(SPARK_CHARS) - 1))
            out.append(SPARK_CHARS[idx])
    return "".join(out)


def timeline_report(doc: dict, as_json: bool = False) -> dict:
    """Render one ``/fleet/timeline`` document: a sparkline row per
    member plus the merged series."""
    if as_json:
        print(json.dumps(doc))
        return doc
    rows = []
    for inst, pts in sorted(doc.get("instances", {}).items()):
        vals = [v for _, v in pts]
        rows.append([inst, len(pts),
                     vals[0] if vals else None,
                     vals[-1] if vals else None,
                     sparkline(vals)])
    merged = doc.get("merged", [])
    mvals = [v for _, v in merged]
    rows.append(["MERGED", len(merged),
                 mvals[0] if mvals else None,
                 mvals[-1] if mvals else None, sparkline(mvals)])
    _print_table(
        f"fleet timeline: {doc.get('series')} "
        f"({doc.get('samples', 0)} samples)",
        ["instance", "points", "first", "last", "trend"], rows)
    return doc


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    as_json = "--json" in argv

    def _opt(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 < len(argv):
                return argv[i + 1]
        return default

    if "--micro" in argv:
        print(json.dumps(run_fleet_micro(device=_opt("--device"))))
        return 0
    if "--timeline" in argv:
        target = _opt("--timeline")
        series = _opt("--series")
        if not target or not series:
            print("--timeline host:port needs --series name",
                  file=sys.stderr)
            return 2
        host, port = target.replace("http://", "").split(":")
        window = _opt("--window")
        try:
            doc = fetch_timeline(
                (host, int(port)), series,
                window=float(window) if window else None)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 1
        timeline_report(doc, as_json=as_json)
        return 0
    if "--url" in argv:
        i = argv.index("--url")
        if i + 1 >= len(argv):
            print("--url needs host:port", file=sys.stderr)
            return 2
        host, port = argv[i + 1].replace("http://", "").split(":")
        addr = (host, int(port))
        st, raw = _http_get(addr, "/fleet/status")
        if st != 200:
            print(f"{addr[0]}:{addr[1]}/fleet/status answered {st} — "
                  "is bigdl.observability.federation on?",
                  file=sys.stderr)
            return 1
        status = json.loads(raw.decode())
        snapshots: Dict[str, dict] = {}
        for name, member in status.get("members", {}).items():
            # scrape target: the advertised address (elastic members
            # are named "pidN"); an addressless legacy status falls
            # back to parsing the name
            target = member.get("address") or []
            try:
                if len(target) != 2:
                    h, p = name.rsplit(":", 1)
                    target = (h, int(p))
                mst, mraw = _http_get((target[0], int(target[1])),
                                      "/metrics/snapshot")
                if mst == 200:
                    snapshots[name] = json.loads(mraw.decode())
            except (OSError, ValueError):
                pass
        report(snapshots, as_json=as_json, status=status)
        return 0
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print(__doc__)
        return 2
    report(load_snapshots(paths), as_json=as_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
