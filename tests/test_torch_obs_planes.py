"""The port's observability and reliability planes and its layered config
(``bigdl_tpu_torch/{observability,reliability,utils/conf.py}``) held to
the JAX package's on the same inputs: exposition text, sketch
quantiles, nested spans, the trace wire both ways, flight ``explain``
verdicts, SLO burns, seeded fault plans, retry / breaker / Retry-After
arithmetic and typed config values. The two packages keep separate
registries, rings and switches, so both live in this one process."""

import random

import pytest

from bigdl_tpu import observability as jobs
from bigdl_tpu import reliability as jrel
from bigdl_tpu.observability import flight as jflight
from bigdl_tpu.observability import metrics as jmetrics
from bigdl_tpu.observability import request_context as jrc
from bigdl_tpu.observability import tracing as jtracing
from bigdl_tpu.observability.sketch import QuantileSketch as JSketch
from bigdl_tpu.observability.slo import SLOAccount as JSLO
from bigdl_tpu.utils import conf as jconf

from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch import reliability as trel
from bigdl_tpu_torch.observability import flight as tflight
from bigdl_tpu_torch.observability import metrics as tmetrics
from bigdl_tpu_torch.observability import request_context as trc
from bigdl_tpu_torch.observability import tracing as ttracing
from bigdl_tpu_torch.observability.sketch import QuantileSketch as TSketch
from bigdl_tpu_torch.observability.slo import SLOAccount as TSLO
from bigdl_tpu_torch.utils import conf as tconf

SIDES = ((jobs, jrel, jflight, jrc, jtracing, JSLO),
         (tobs, trel, tflight, trc, ttracing, TSLO))


@pytest.fixture()
def clean():
    """Empty registries, rings and plans on both sides, the flight
    recorders on, and everything put back after."""
    for obs, rel, fl, *_ in SIDES:
        obs.reset()
        obs.enable()
        rel.enable()
        rel.set_plan(None)
        fl.enabled = True
    yield
    for obs, rel, fl, *_ in SIDES:
        fl.enabled = False
        rel.set_plan(None)
        obs.reset()


def _observe(metrics):
    """One fixed set of observations into a fresh registry of ``metrics``."""
    reg = metrics.MetricRegistry()
    c = reg.counter("bigdl_t_requests_total", "Requests by reason",
                    labelnames=("reason",))
    c.labels(reason="done").inc(3)
    c.labels(reason='we"ird\\').inc()
    reg.gauge("bigdl_t_depth", "Queue depth").set(2.5)
    h = reg.histogram("bigdl_t_seconds", "Step time",
                      buckets=metrics.FAST_BUCKETS)
    s = reg.sketch("bigdl_t_ttft_seconds", "TTFT", labelnames=("slo",))
    rs = random.Random(5)
    for _ in range(200):
        v = rs.expovariate(20.0)
        h.observe(v)
        s.labels(slo="ttft").observe(v)
    return reg


def test_exposition_byte_equal():
    want = jmetrics.render_prometheus(_observe(jmetrics))
    got = tmetrics.render_prometheus(_observe(tmetrics))
    assert got == want
    assert tmetrics.parse_prometheus(got) == jmetrics.parse_prometheus(want)
    assert tobs.CONTENT_TYPE == jobs.CONTENT_TYPE


@pytest.mark.parametrize("alpha", [0.01, 0.05])
def test_sketch_quantiles_and_merge(alpha):
    rs = random.Random(9)
    vals = [rs.lognormvariate(-3, 1.5) for _ in range(500)] + [0.0, -1.0]
    sides = []
    for cls in (JSketch, TSketch):
        a, b = cls(alpha), cls(alpha)
        for k, v in enumerate(vals):
            (a if k % 2 else b).observe(v)
        a.merge(b)
        snap = a.to_snapshot()
        sides.append((a.quantiles((0.1, 0.5, 0.9, 0.99)), a.count,
                      a.sum, snap, cls.from_snapshot(snap).quantile(0.5)))
    assert sides[0] == sides[1]


def _spans(obs, rc, tracing):
    """Nested spans under an activated context, plus a recorded complete
    event; their names, args and parenting."""
    ctx = rc.TraceContext("a" * 32, "b" * 16)
    with rc.activate(ctx):
        with obs.span("llm/request", stage="llm_worker"):
            with obs.span("llm/prefill", slot=1, tokens=7):
                obs.add_complete("llm/queue_wait", 1.0, 0.5, stage="queue")
    out = []
    for r in obs.TRACE.spans():
        a = dict(r["args"])
        out.append((r["name"], r["ph"], a.pop("trace", None),
                    a.pop("parent_span", None) is not None,
                    a.pop("span", None) is not None, sorted(a.items())))
    asm = tracing.assemble_trace("a" * 32)
    return out, asm["span_count"], sorted(asm["stages"])


def test_nested_spans_match(clean):
    assert _spans(tobs, trc, ttracing) == _spans(jobs, jrc, jtracing)


def test_span_torch_passthrough(clean):
    """With the passthrough on, spans label a torch profiler trace."""
    import torch
    ttracing.configure(torch_passthrough=True)
    try:
        with torch.profiler.profile() as prof:
            with tobs.span("llm/prefill"):
                torch.ones(4).sum()
    finally:
        ttracing.configure(torch_passthrough=False)
    assert "llm/prefill" in {e.name for e in prof.events()}


def test_trace_wire_crosses_both_ways(clean):
    for src, dst in ((jrc, trc), (trc, jrc)):
        ctx = src.new_trace().child()
        back = dst.from_wire(src.to_wire(ctx))
        assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
        hdrs = dict(src.to_headers(ctx))
        got = dst.from_headers({k.lower(): v for k, v in hdrs.items()})
        assert got.trace_id == ctx.trace_id and got.span_id == ctx.span_id
    assert (trc.TRACE_HEADER, trc.PARENT_HEADER) == \
        (jrc.TRACE_HEADER, jrc.PARENT_HEADER)


def _flight(fl):
    """One request's decision story (and a router event on its trace)."""
    fl.record("queue", request_id="r1", trace_id="t1", prompt_tokens=9)
    fl.record("radix_hit", request_id="r1", trace_id="t1",
              matched_tokens=16)
    fl.record("fetch", request_id="r1", trace_id="t1", wait_ms=41.0,
              status="degraded")
    for _ in range(3):
        fl.record("chunk_charge", request_id="r1", trace_id="t1")
    fl.record("failover", request_id="x", trace_id="t1")
    fl.record("finish", request_id="r1", trace_id="t1", ttft_ms=812.5)
    fl.record("shed", request_id="r2", component="llm_server",
              reason="queue_full")
    out = []
    for rid in ("r1", "r2", "none"):
        doc = fl.explain(rid)
        out.append((doc["verdict"], [e["kind"] for e in doc["events"]]))
    code, body = fl.debug_endpoint("/debug/flight?kind=chunk_charge&limit=2")
    out.append((code, len(body["events"]), body["kinds"]))
    out.append(fl.debug_endpoint("/debug/explain/none")[0])
    return out


def test_flight_explain_matches(clean):
    assert _flight(tflight) == _flight(jflight)
    tflight.enabled = False
    assert tflight.debug_endpoint("/debug/flight")[0] == 404


def _slo(cls):
    acc = cls("engine", ttft_ms=100, itl_ms=20, window=4)
    for ttft, itl in ((0.05, 0.01), (0.2, None), (None, 0.03),
                      (0.09, 0.019), (0.5, 0.5), (0.01, 0.001)):
        acc.finish(ttft, itl)
    return acc.status(), acc.burn_rates()


def test_slo_burns_match(clean):
    assert _slo(TSLO) == _slo(JSLO)
    assert TSLO.if_enabled("engine") is None
    assert TSLO.if_enabled("engine", enabled=True).scope == "engine"


def _faults(rel):
    plan = rel.FaultPlan(seed=7)
    plan.add("llm.step", "raise", after=2, times=1)
    plan.add("kvtier.*", "delay", delay=0.0, times=2)
    plan.add("llm.spec", "raise", prob=0.5, times=None)
    plan.randomize(3, sites=("llm.chunk", "llm.preempt"),
                   actions=("raise", "delay"))
    rel.set_plan(plan)
    out = []
    for site in ["llm.step"] * 4 + ["kvtier.spill", "kvtier.fetch"] * 2 + \
            ["llm.spec"] * 6 + ["llm.chunk", "llm.preempt"] * 3:
        try:
            out.append(rel.inject(site))
        except rel.InjectedFault as e:
            out.append(str(e))
    rel.set_plan(None)
    return out, plan.fired, rel.armed_sites()


def test_seeded_fault_plan_fires_alike(clean):
    assert _faults(trel) == _faults(jrel)
    assert trel.SITES == jrel.SITES


def _policies(rel):
    now = [0.0]
    delays = list(rel.RetryPolicy(max_attempts=6, base_delay=0.1,
                                  max_delay=1.0, seed=3).delays())
    br = rel.CircuitBreaker("b", failure_threshold=2, reset_timeout=5.0,
                            clock=lambda: now[0])
    states = []
    for ev, dt in (("f", 0), ("f", 0), ("s", 1), ("-", 5), ("f", 0),
                   ("-", 6), ("s", 0)):
        now[0] += dt
        {"f": br.record_failure, "s": br.record_success,
         "-": lambda: None}[ev]()
        states.append((br.state, br.allow()))
    ra = [rel.retry_after_seconds(d, rng=random.Random(d))
          for d in (0, 3, 40, 200)]
    return delays, states, ra


def test_retry_breaker_retry_after_match(clean):
    assert _policies(trel) == _policies(jrel)
    assert issubclass(trel.OverloadError, RuntimeError)


ENV = {"BIGDL_TPU_LLM_PIPELINE_DEPTH": "3",
       "BIGDL_TPU_LLM_KVCACHE_ENABLED": "true",
       "BIGDL_TPU_LLM_PREFILL_CHUNK_WAIT": "2.5",
       "BIGDL_TPU_LLM_ROLE": "decode",
       "BIGDL_TPU_SLO_TTFT_MS": "250"}


def test_conf_layers_match(monkeypatch, tmp_path):
    """The environment, a ``bigdl-tpu.conf`` file and ``set`` resolve to
    the same typed values in both packages; the defaults tables are the
    same."""
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    f = tmp_path / "bigdl-tpu.conf"
    f.write_text("# deployment\nbigdl.llm.spec.k = 6\n"
                 "bigdl.llm.role = prefill\n")
    sides = []
    for mod in (jconf, tconf):
        c = mod.BigDLConf(str(f))
        c.set("bigdl.llm.watchdog.step_timeout", 1.5)
        sides.append((
            c.get_int("bigdl.llm.pipeline_depth"),
            c.get_bool("bigdl.llm.kvcache.enabled"),
            c.get_float("bigdl.llm.prefill.chunk.wait"),
            c.get("bigdl.llm.role"), c.get_int("bigdl.llm.spec.k"),
            c.get_float("bigdl.llm.watchdog.step_timeout"),
            c.get_float("bigdl.slo.ttft_ms"),
            c.get_bool("bigdl.llm.api.enabled"), c.effective()))
        with pytest.raises(ValueError):
            c.set("bigdl.llm.kvcache.enabled", "maybe")
            c.get_bool("bigdl.llm.kvcache.enabled")
    assert sides[0] == sides[1]
    assert sides[1][:6] == (3, True, 2.5, "decode", 6, 1.5)
    assert tconf._DEFAULTS == jconf._DEFAULTS


def test_disabled_mode_records_nothing(clean):
    """Observability off: the same calls leave the same (empty) exposition
    and no span in either package."""
    out = []
    for obs, *_ in SIDES:
        obs.disable()
        try:
            obs.counter("bigdl_x_total", "x").inc()
            with obs.span("llm/prefill"):
                pass
            out.append((obs.render(), len(obs.TRACE)))
        finally:
            obs.enable()
    assert out[0] == out[1]
    assert "bigdl_x_total 1" not in out[1][0] and out[1][1] == 0


def test_unported_switches_raise(clean):
    """The switch that raised before the time-series plane was ported
    now builds the plane: the store and the alert engine exist, and
    ``/metrics/query`` answers over them (404 naming the gate when
    off), as in the JAX package."""
    from bigdl_tpu_torch.observability import alerts, timeseries
    from bigdl_tpu_torch.utils.conf import conf
    gate = "bigdl.observability.timeseries.enabled"
    path = "/metrics/query?series=bigdl_timeseries_samples_total&fn=delta"
    assert timeseries.debug_endpoint(path)[0] == 404
    conf.set(gate, "true")
    conf.set("bigdl.observability.timeseries.interval", "3600")
    try:
        st = timeseries.acquire()
        assert st is timeseries.store() and alerts.engine().store is st
        for _ in range(3):     # the series is born at the first sample
            st.sample_now()
        status, body = timeseries.debug_endpoint(path)
        assert status == 200 and body["value"] == 1.0
        assert body["samples"] == 2 and body["instance"] == "local"
    finally:
        timeseries.release()
        conf.unset("bigdl.observability.timeseries.interval")
        conf.unset(gate)
    assert timeseries.debug_endpoint(path)[0] == 404
