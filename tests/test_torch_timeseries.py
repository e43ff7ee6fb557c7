"""The port's time-series plane and alert engine
(``bigdl_tpu_torch/observability/{timeseries,alerts}.py``) held to the
JAX package's on the same inputs, exactly (NaN where JAX gives NaN): the
window primitives, the store's windows over one sample sequence (fake
clock, stub federation members: resets, retention, stale and departed
members, merged queries, ``timeline``, ``status``), ``parse_series``,
the alert engine's rules, transitions, flight events and counter deltas,
the gate's lifecycle (disabled builds no thread and no series), and the
``/metrics/query``, ``/fleet/timeline`` and ``/alerts`` bodies and codes
— direct and over both packages' routers and workers."""

import http.client
import json
import math
import threading

import pytest

from bigdl_tpu import observability as jobs
from bigdl_tpu.llm import worker as jworker
from bigdl_tpu.observability import alerts as jalerts
from bigdl_tpu.observability import flight as jflight
from bigdl_tpu.observability import timeseries as jts
from bigdl_tpu.observability.sketch import QuantileSketch as JSketch
from bigdl_tpu.utils.conf import conf as jconf

from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch.llm import worker as tworker
from bigdl_tpu_torch.observability import alerts as talerts
from bigdl_tpu_torch.observability import flight as tflight
from bigdl_tpu_torch.observability import timeseries as tts
from bigdl_tpu_torch.observability.sketch import QuantileSketch as TSketch
from bigdl_tpu_torch.utils.conf import conf as tconf

GATE = "bigdl.observability.timeseries.enabled"
KEYS = (GATE, "bigdl.observability.timeseries.interval",
        "bigdl.observability.timeseries.retention",
        "bigdl.observability.alerts.rules",
        "bigdl.observability.flight.enabled", "bigdl.slo.objective")
SIDES = {"jax": (jts, jalerts, jflight, jobs, jconf, JSketch, jworker),
         "torch": (tts, talerts, tflight, tobs, tconf, TSketch, tworker)}
BOTH = pytest.mark.parametrize("side", list(SIDES))


@pytest.fixture(autouse=True)
def _clean():
    """Observability on, the gate at its default (off), no live store or
    engine on either side, and every key put back after."""
    for ts, al, fl, obs, *_ in SIDES.values():
        obs.enable()
        ts.reset()
        al.reset()
        fl.reset()
    yield
    for ts, al, fl, obs, conf, *_ in SIDES.values():
        for key in KEYS:
            conf.unset(key)
        ts.reset()
        al.reset()
        fl.reset()


def _norm(x):
    """NaN-aware, order-preserving form for exact comparison."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _same(fn):
    """``fn(side)`` on both packages: equal, NaN where JAX gives NaN."""
    want, got = (_norm(fn(side)) for side in SIDES)
    assert got == want
    return got


def _doc(counters=None, gauges=None, sketches=None, hists=None):
    """A federation wire snapshot of unlabeled series."""
    metrics = []
    for kind, vals, key in (("counter", counters, "value"),
                            ("gauge", gauges, "value"),
                            ("summary", sketches, "sketch")):
        for name, v in (vals or {}).items():
            metrics.append({"name": name, "kind": kind, "help": "",
                            "labelnames": [],
                            "series": [{"labels": [], key: v}]})
    for name, (cum, s, n) in (hists or {}).items():
        metrics.append({"name": name, "kind": "histogram", "help": "",
                        "labelnames": [], "series": [{
                            "labels": [], "bounds": [0.1, 1.0],
                            "cum": cum, "sum": s, "count": n}]})
    return {"instance": "synthetic", "ts": 0.0, "metrics": metrics}


def _slo_doc(ok, violated):
    doc = _doc()
    doc["metrics"].append({
        "name": "bigdl_slo_requests_total", "kind": "counter", "help": "",
        "labelnames": ["slo", "verdict"],
        "series": [{"labels": ["ttft", "ok"], "value": float(ok)},
                   {"labels": ["ttft", "violated"],
                    "value": float(violated)}]})
    return doc


class _Stub:
    """The federation collector as the store reads it."""

    def __init__(self, include_self="m1"):
        self.include_self = include_self
        self.snaps, self.stale = {}, set()

    def snapshots(self):
        return dict(self.snaps)

    def stale_instances(self):
        return set(self.stale)


def _snap(side, values, alpha=0.01):
    sk = SIDES[side][5](alpha=alpha)
    for v in values:
        sk.observe(v)
    return sk.to_snapshot()


def _feed(st, coll, seq):
    """``seq``: ``[(now, {member: doc}, stale)]`` sampled in order."""
    for now, snaps, stale in seq:
        coll.snaps, coll.stale = snaps, set(stale)
        st.sample_now(now=now)


# ---------------------------------------------------------------------------
# the window primitives
# ---------------------------------------------------------------------------

def _wc(ts):
    wc = ts.WindowedCounter()
    return [wc.observe(v) for v in (
        {"a": 5.0, "b": 3.0}, {"a": 7.0, "b": 3.0}, {"a": 1.0, "b": 6.0},
        {"a": 1.0}, {"a": 1.0, "b": 9.0})]


H0 = {"bounds": [1.0], "cum": [2], "sum": 3.0, "count": 4}
H1 = {"bounds": [1.0], "cum": [5], "sum": 9.0, "count": 8}


@pytest.mark.parametrize("case", [
    lambda ts, s: [ts.counter_delta(v) for v in
                   ([5.0, 9.0, 2.0, 4.0], [], [7.0])],
    lambda ts, s: [ts.counter_rate(p) for p in (
        [(0.0, 0.0), (10.0, 40.0)], [(5.0, 1.0)],
        [(5.0, 1.0), (5.0, 2.0)])],
    lambda ts, s: [ts.gauge_stats([]), ts.gauge_stats([2.0, 8.0, 5.0])],
    lambda ts, s: [ts.histogram_delta(H0, H1), ts.histogram_delta(H1, H0),
                   ts.histogram_delta(None, H1),
                   ts.histogram_delta(H0, dict(H1, bounds=[2.0]))],
    lambda ts, s: _wc(ts),
    lambda ts, s: ts.sketch_window(s([0.1] * 50), s([0.1] * 50 + [5.0] * 50),
                                   qs=(0.5, 0.99)),
    lambda ts, s: [ts.sketch_delta(s([0.1] * 20), s([9.0] * 20, 0.02)),
                   ts.sketch_delta(s([1.0] * 30), s([2.0] * 10)),
                   ts.sketch_delta(None, s([1.0])),
                   ts.sketch_delta(s([1.0]), None)],
    lambda ts, s: ts.sketch_window(s([1.0] * 10), s([1.0] * 10)),
    lambda ts, s: [ts.parse_series(e) for e in (
        'bigdl_slo_requests_total{slo="ttft",verdict="ok"}',
        "plain_total", "x{a='1', b=2,}")],
], ids=["counter_delta", "counter_rate", "gauge_stats", "histogram_delta",
        "windowed_counter", "sketch_window", "sketch_delta",
        "empty_window", "parse_series"])
def test_primitives(case):
    _same(lambda side: case(SIDES[side][0],
                            lambda v, a=0.01: _snap(side, v, a)))


@BOTH
def test_parse_series_rejects(side):
    with pytest.raises(ValueError, match="bad series selector"):
        SIDES[side][0].parse_series("bad{unclosed")


# ---------------------------------------------------------------------------
# the store over one sample sequence
# ---------------------------------------------------------------------------

def _c(v):
    return _doc(counters={"x_total": v})


def _queries(st, now, window):
    """Every query kind over the window, per member and merged."""
    out = {}
    for name in ("x_total", "g", "h", "lat", "nope"):
        for fn in ("delta", "rate", "avg", "min", "max", "last", "p50",
                   "p99", "count"):
            for inst in ("m1", "m2", "*"):
                out[f"{name}/{fn}/{inst}"] = st.query(
                    name, fn, window=window, instance=inst, now=now)
    out["instances"] = st.instances(window, now)
    out["timeline"] = [st.timeline(n, window=window, now=now)
                       for n in ("x_total", "g", "h", "lat")]
    return out


SEQS = {
    "counter_reset": lambda s: [
        (now, {"m1": _c(v)}, ()) for now, v in
        ((0.0, 100.0), (10.0, 130.0), (20.0, 5.0), (30.0, 12.0))],
    "stale_member": lambda s: [
        (0.0, {"m1": _c(1.0), "m2": _c(100.0)}, ()),
        (10.0, {"m1": _c(4.0), "m2": _c(100.0)}, ("m2",))],
    "departed_member": lambda s: [
        (0.0, {"m1": _c(10.0), "m2": _c(50.0)}, ()),
        (10.0, {"m1": _c(12.0), "m2": _c(55.0)}, ()),
        (20.0, {"m1": _c(15.0)}, ())],
    "merged_reset": lambda s: [
        (0.0, {"m1": _c(90.0), "m2": _c(10.0)}, ()),
        (10.0, {"m1": _c(2.0), "m2": _c(30.0)}, ())],
    "gauges_hists": lambda s: [
        (now, {"m1": _doc(gauges={"g": a}, hists={"h": ([1, c], c, c)}),
               "m2": _doc(gauges={"g": b})}, ())
        for now, a, b, c in ((0.0, 2.0, 4.0, 3), (10.0, 4.0, 4.0, 7),
                             (20.0, 1.0, 6.0, 2))],
    "sketches": lambda s: [
        (0.0, {"m1": _doc(sketches={"lat": s([1.0], 0.01)}),
               "m2": _doc(sketches={"lat": s([9.0], 0.05)})}, ()),
        (10.0, {"m1": _doc(sketches={"lat": s([1.0] * 40 + [3.0], 0.01)}),
                "m2": _doc(sketches={"lat": s([9.0] * 40, 0.05)})}, ())],
    "one_point": lambda s: [(0.0, {"m1": _c(9.0)}, ())],
}


@pytest.mark.parametrize("name", list(SEQS))
@pytest.mark.parametrize("window", [10.0, 30.0, None])
def test_store_windows(name, window):
    def run(side):
        ts = SIDES[side][0]
        st = ts.TimeSeriesStore(interval=1.0, retention=600.0,
                                clock=lambda: 0.0)
        coll = _Stub()
        st.attach_collector(coll)
        nan_before = _norm(st.query("x_total", "delta", window=60.0))
        seq = SEQS[name](lambda v, a: _snap(side, v, a))
        _feed(st, coll, seq)
        out = _queries(st, seq[-1][0], window)
        status = st.status()
        status.pop("sample_overhead_us")
        return [nan_before, out, status, len(st), st.samples_total]
    _same(run)


def test_retention_and_eviction():
    def run(side):
        st = SIDES[side][0].TimeSeriesStore(interval=1.0, retention=30.0,
                                            clock=lambda: 0.0)
        coll = _Stub()
        st.attach_collector(coll)
        _feed(st, coll, [(now, {"m1": _c(now)}, ())
                         for now in (0.0, 10.0, 20.0, 40.0)])
        return [len(st), st.evicted, st._window(None, 40.0)[0][0],
                st.query("x_total", "delta", instance="m1")]
    assert _same(run) == [3, 1, 10.0, 30.0]


# ---------------------------------------------------------------------------
# the alert engine over one sample sequence
# ---------------------------------------------------------------------------

BURN = {"name": "fb", "kind": "burn_rate", "slo": "ttft", "short": 10.0,
        "long": 20.0, "factor": 5.0, "objective": 0.99}
RULES = {
    "burn_fires_resolves": ([BURN], [
        (0.0, _slo_doc(10, 0), True), (10.0, _slo_doc(12, 10), True),
        (50.0, _slo_doc(20, 10), False), (55.0, _slo_doc(25, 10), True)]),
    "burn_needs_both": ([dict(BURN, long=100.0, objective=0.9)], [
        (0.0, _slo_doc(1000, 0), False), (95.0, _slo_doc(2000, 0), False),
        (100.0, _slo_doc(2000, 30), True)]),
    "threshold_for": ([{"name": "qh", "kind": "threshold", "series": "q",
                        "fn": "last", "window": 30.0, "op": ">",
                        "value": 5.0, "for": 10.0}], [
        (0.0, _doc(gauges={"q": 9.0}), True),
        (5.0, _doc(gauges={"q": 9.0}), True),
        (12.0, _doc(gauges={"q": 9.0}), True),
        (20.0, _doc(gauges={"q": 0.0}), True),
        (25.0, _doc(gauges={"q": 7.0}), True),
        (26.0, _doc(gauges={"q": 1.0}), True)]),
    "absence": ([{"name": "ab", "kind": "absence", "series": "heartbeat",
                  "window": 30.0, "instance": "m1"}], [
        (None, None, True), (10.0, _doc(gauges={"other": 1.0}), True),
        (20.0, _doc(gauges={"heartbeat": 1.0}), True)]),
    "record_and_ops": ([
        {"name": "qdepth", "kind": "record", "series": "q", "fn": "last",
         "window": 30.0, "instance": "m1"},
        {"name": "le", "kind": "threshold", "series": "q", "op": "<=",
         "value": 7.0},
        {"name": "bad", "kind": "threshold", "series": "q", "op": "!!"},
        {"name": "broken", "kind": "burn_rate"}], [
        (0.0, _doc(gauges={"q": 7.0}), True),
        (1.0, _doc(gauges={"q": 8.0}), True)]),
}


@pytest.mark.parametrize("name", list(RULES))
def test_alert_engine(name):
    """Rules evaluated on one sequence: the state after every
    evaluation, the ``/alerts`` body, the flight events and the
    ``bigdl_alerts_*`` series' deltas."""
    rules, seq = RULES[name]

    def run(side):
        ts, al, fl, obs, conf, *_ = SIDES[side]
        conf.set("bigdl.observability.flight.enabled", "true")
        reg = obs.REGISTRY
        names = [r["name"] for r in rules]

        def counts():
            return [reg.sample_value("bigdl_alerts_transitions_total",
                                     rule=n, state=s) or 0.0
                    for n in names
                    for s in ("pending", "firing", "resolved", "inactive")]
        before = counts()
        st = ts.TimeSeriesStore(interval=1.0, retention=600.0,
                                clock=lambda: 0.0)
        coll = _Stub()
        st.attach_collector(coll)
        eng = al.AlertEngine(st, rules=rules)
        trail = []
        for now, doc, evaluate in seq:
            if doc is not None:
                coll.snaps = {"m1": doc}
                st.sample_now(now=now)
            if evaluate:
                eng.evaluate(0.0 if now is None else now)
                trail.append([eng.firing(), [r["state"] for r in
                                             eng.status()["rules"]]])
        evs = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
               for e in (fl.ring().events() if fl.ring() else [])]
        return [trail, eng.status(), evs,
                [a - b for a, b in zip(counts(), before)],
                reg.sample_value("bigdl_alerts_firing"),
                reg.sample_value("bigdl_alerts_recorded", rule="qdepth")]
    _same(run)


def test_rules_override_and_fallback():
    def run(side):
        al, conf = SIDES[side][1], SIDES[side][4]
        out = [al.default_rules(), list(al.FAST_BURN), list(al.SLOW_BURN)]
        for raw in ('[{"name": "only", "kind": "threshold", "series": "q",'
                    ' "value": 1}]', "{broken json", '{"a": 1}',
                    '[{"kind": "threshold"}]', "   "):
            conf.set("bigdl.observability.alerts.rules", raw)
            out.append(al.load_rules())
        return out
    assert [r["name"] for r in _same(run)[3]] == ["only"]


# ---------------------------------------------------------------------------
# the gate's lifecycle and the endpoints
# ---------------------------------------------------------------------------

PATHS = ("/metrics/query?series=x_total&window=60",
         "/fleet/timeline?series=x_total", "/alerts")


@BOTH
def test_disabled_is_structurally_absent(side):
    ts, al, fl, obs, *_ = SIDES[side]
    assert not ts.enabled
    before = set(obs.render().splitlines())
    assert ts.acquire() is None and ts.store() is None
    assert al.engine() is None and ts.sample_now(now=0.0) is None
    assert ts.slo_burn("ttft", "router") is None
    ts.attach_collector(_Stub())
    assert ts.store() is None
    for path in PATHS:
        got = ts.debug_endpoint(path) or al.debug_endpoint(path)
        assert got == (404, {"error": "timeseries disabled", "gate": GATE})
    assert ts.debug_endpoint("/metrics") is None
    assert not [t for t in threading.enumerate()
                if t.name == ts.TimeSeriesStore.THREAD_NAME]
    grown = set(obs.render().splitlines()) - before
    assert not [g for g in grown if "bigdl_timeseries" in g
                or "bigdl_alerts" in g]


@BOTH
def test_acquire_release_and_conf_refresh(side):
    ts, al, _, obs, conf, *_ = SIDES[side]

    def threads():
        return [t for t in threading.enumerate()
                if t.name == ts.TimeSeriesStore.THREAD_NAME]
    conf.set(GATE, "true")
    assert ts.enabled
    conf.set("bigdl.observability.timeseries.interval", "3600")
    st = ts.acquire()
    assert st is ts.store() is ts.acquire() and al.engine().store is st
    assert al.engine().evaluate in st.on_sample and threads()
    conf.set("bigdl.observability.timeseries.retention", "42")
    conf.set("bigdl.observability.timeseries.interval", "1800")
    assert (st.retention, st.interval) == (42.0, 1800.0)
    ts.release()
    assert threads()
    ts.release()
    assert not threads()
    ts.release()                           # an extra release is harmless
    conf.unset(GATE)
    assert not ts.enabled


@BOTH
def test_slo_burn_from_store_windows(side):
    ts, _, _, obs, conf, *_ = SIDES[side]
    conf.set(GATE, "true")
    conf.set("bigdl.observability.timeseries.interval", "3600")
    st = ts.acquire()
    try:
        assert ts.slo_burn("ttft", "ts-test", window=60.0, now=0.0) is None
        reqs = obs.counter("bigdl_slo_requests_total",
                           labelnames=("slo", "verdict", "scope"))
        st.sample_now(now=0.0)
        reqs.labels(slo="ttft", verdict="ok", scope="ts-test").inc(6)
        reqs.labels(slo="ttft", verdict="violated", scope="ts-test").inc(2)
        st.sample_now(now=10.0)
        assert ts.slo_burn("ttft", "ts-test", window=60.0,
                           now=10.0) == 0.25
        assert ts.slo_burn("ttft", "no-such-scope", window=60.0,
                           now=10.0) == 0.0
    finally:
        ts.release()


QUERIES = (
    "/metrics/query?series=x_total&window=600&fn=delta",
    "/metrics/query?series=x_total&window=600&fn=rate&instance=*",
    "/metrics/query?series=x_total&fn=rate&instance=m2",
    "/metrics/query?series=lat&window=15&fn=p99",
    "/metrics/query?series=g&window=600",
    "/metrics/query?series=nope_total&window=600&fn=delta",
    "/metrics/query?series=bigdl_slo_requests_total{verdict=ok}&fn=delta",
    "/fleet/timeline?series=x_total&window=600",
    "/fleet/timeline?series=g{a=1}", "/fleet/timeline?series=lat",
    "/metrics/query?series=x&window=nope", "/metrics/query",
    "/fleet/timeline?window=5", "/metrics/query?series=bad{unclosed",
    "/alerts")


def _endpoints(side, seq_fn, http_addr=None):
    """Endpoint answers after one sample sequence on the live store,
    read directly or over a surface's HTTP."""
    ts, al, *_ = SIDES[side]
    st = ts.store()
    coll = _Stub()
    ts.attach_collector(coll)
    _feed(st, coll, seq_fn(lambda v, a: _snap(side, v, a)))
    out = []
    for path in QUERIES:
        if http_addr is None:
            got = ts.debug_endpoint(path) or al.debug_endpoint(path)
        else:
            conn = http.client.HTTPConnection(*http_addr, timeout=30)
            try:
                conn.request("GET", path)
                r = conn.getresponse()
                got = (r.status, json.loads(r.read().decode()))
            finally:
                conn.close()
        out.append(json.loads(json.dumps(got)))
    return out


def _seq(s):
    rows = []
    for i, now in enumerate((0.0, 5.0, 10.0, 20.0)):
        doc = _slo_doc(10 + i, 3 * i)
        doc["metrics"] += _doc(
            counters={"x_total": 5.0 * i * i},
            gauges={"g": float(i)},
            sketches={"lat": s([0.1] * (10 + i) + [2.0] * i, 0.01)}
        )["metrics"]
        rows.append((now, {"m1": doc, "m2": _c(3.0 + i)}, ()))
    return rows


class _FakeEngine:
    """What a worker reads of an engine at construction."""
    model = None
    watchdog_enabled = False


RULE_JSON = json.dumps([
    {"name": "fb", "kind": "burn_rate", "slo": "ttft", "short": 10.0,
     "long": 20.0, "factor": 1.5, "objective": 0.9},
    {"name": "x", "kind": "threshold", "series": "x_total", "fn": "delta",
     "window": 600.0, "op": ">", "value": 10.0}])


@pytest.mark.parametrize("surface", ["direct", "router", "worker"])
def test_endpoints_over_live_store(surface):
    """The three endpoints' bodies and codes (including the 400s) after
    the same sample sequence, from the module, a router and a worker of
    each package; the surface's stop releases the plane."""
    def run(side):
        ts, al, fl, obs, conf, _, wk = SIDES[side]
        conf.set(GATE, "true")
        conf.set("bigdl.observability.timeseries.interval", "3600")
        conf.set("bigdl.observability.alerts.rules", RULE_JSON)
        if surface == "direct":
            ts.acquire()
            try:
                assert al.debug_endpoint("/alerts")[1]["evaluations"] == 0
                return _endpoints(side, _seq)
            finally:
                ts.release()
        if surface == "router":
            srf = wk.LLMRouter([], [("127.0.0.1", 1)],
                               start_prober=False).start()
        else:
            srf = wk.LLMWorker(_FakeEngine()).start()
        try:
            return _endpoints(side, _seq, srf.address)
        finally:
            srf.stop()
            assert not [t for t in threading.enumerate()
                        if t.name == ts.TimeSeriesStore.THREAD_NAME]
    got = _same(run)
    assert got[0][0] == 200 and got[0][1]["value"] == 45.0
    assert [g[0] for g in got[-5:-1]] == [400, 400, 400, 400]
    assert got[-1][1]["firing"] == ["fb", "x"]

