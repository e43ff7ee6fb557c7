"""The port's engine instruments (``bigdl_tpu_torch/llm/serving.py``,
``kvcache``, ``kvtier``) against the JAX engine's, both engines driven
inline on one schedule over the same tiny f32 q4_0 weights, in five
modes (plain, prefix cache + mixed dispatch, speculation, priority
classes, the synchronous host tier): the series minted (names and label
sets), every counter, every histogram's count and every gauge's final
value, the flight event kinds of each request, ``slo=True``'s series and
the trace spans of a request submitted under a trace. Then the
reliability plane: a seeded raise at each engine fault site fires and
is handled alike, the watchdog trips alike, an injected raise at
``llm.step`` is retried alike, the layered config turns the prefix cache
on alike, and the engine's ``OverloadError`` is the reliability plane's.
Series of planes the port has not ported (the JAX package's compile
recorder, ``bigdl_xla_*``, and utilization, ``bigdl_device_*``) are left
out of the comparison."""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import observability as jobs
from bigdl_tpu import reliability as jrel
from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.llm.serving import LLMServer as JServer
from bigdl_tpu.observability import flight as jflight
from bigdl_tpu.observability import request_context as jrc

from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch import reliability as trel
from bigdl_tpu_torch.llm import serving
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer
from bigdl_tpu_torch.observability import flight as tflight
from bigdl_tpu_torch.observability import request_context as trc

PAGE = 8
UNPORTED = ("bigdl_xla_", "bigdl_device_")
SIDES = ((jobs, jrel, jflight), (tobs, trel, tflight))


@pytest.fixture(scope="module")
def pair():
    cfg = jllama.LlamaConfig.tiny()
    p = jllama.quantize_params(jllama.init_params(cfg, 0, dtype=jnp.float32),
                               "sym_int4")
    jm = jllama.LlamaForCausalLM(cfg, p, max_cache_len=128,
                                 cache_dtype=jnp.float32)
    tm = tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
        cache_dtype=torch.float32, page_size=PAGE, device="cpu")
    return jm, tm


@pytest.fixture()
def planes(monkeypatch):
    """Fresh registries and flight rings on both sides, the recorders on,
    SLO thresholds no CPU run can miss (verdicts must not depend on
    host speed), the tier inline in both engines."""
    monkeypatch.setenv("BIGDL_TPU_SLO_TTFT_MS", "600000")
    monkeypatch.setenv("BIGDL_TPU_SLO_ITL_MS", "600000")
    monkeypatch.setenv("BIGDL_TPU_LLM_KVTIER_SYNC", "true")
    for obs, rel, fl in SIDES:
        obs.reset()
        obs.enable()
        rel.set_plan(None)
        fl.enabled = True
    yield
    for obs, rel, fl in SIDES:
        fl.enabled = False
        rel.set_plan(None)
        obs.reset()


def _inline(srv, reqs):
    """Drive the engine's passes until ``reqs`` are done; a pass an
    injected fault fails is retried, as the engine loop retries it."""
    while not all(r.done.is_set() for r in reqs):
        try:
            srv._admit()
            srv._step()
        except (jrel.InjectedFault, trel.InjectedFault):
            pass


def _finish(srv):
    while srv._inflight:
        srv._drain_next()


def _plain(srv, rc):
    rs = np.random.RandomState(3)
    ctx = rc.TraceContext("c" * 32, "d" * 16)
    reqs = []
    for k, (n, m) in enumerate(((5, 6), (17, 4), (9, 8), (30, 5), (12, 7))):
        with rc.activate(ctx if k == 1 else None):
            reqs.append(srv.submit(rs.randint(0, 250, n).astype(np.int32),
                                   m))
    _inline(srv, reqs)
    _finish(srv)
    return reqs


def _cache_mixed(srv, rc):
    rs = np.random.RandomState(14)
    shared = rs.randint(0, 250, 20).astype(np.int32)
    prompts = [np.concatenate([shared, rs.randint(0, 250, 11 + 4 * j)
                               .astype(np.int32)]) for j in range(3)]
    prompts.append(rs.randint(0, 250, 6).astype(np.int32))
    reqs = []
    for _ in range(2):
        new = [srv.submit(p, n) for p, n in zip(prompts, (4, 3, 5, 4))]
        _inline(srv, new)
        reqs += new
    _finish(srv)
    return reqs


def _spec(srv, rc):
    rs = np.random.RandomState(42)
    pattern = rs.randint(0, 250, 5).astype(np.int32)
    reqs = [srv.submit(np.tile(pattern, 6).astype(np.int32), 24),
            srv.submit(rs.randint(0, 250, 7).astype(np.int32), 6)]
    _inline(srv, reqs)
    _finish(srv)
    return reqs


def _priority(srv, rc):
    rs = np.random.RandomState(11)
    batch = [rs.randint(0, 250, 10 + 3 * j).astype(np.int32)
             for j in range(3)]
    inter = [rs.randint(0, 250, 6 + j).astype(np.int32) for j in range(2)]
    reqs = [srv.submit(p, 12, priority="batch") for p in batch]
    for _ in range(5):
        srv._admit()
        srv._step()
    reqs += [srv.submit(p, 4, priority="interactive") for p in inter]
    _inline(srv, reqs)
    _finish(srv)
    return reqs


def _tier(srv, rc):
    rs = np.random.RandomState(17)
    groups = [rs.randint(0, 250, 16).astype(np.int32) for _ in range(4)]
    reqs = []
    for rnd in range(2):
        for g in range(4):
            p = np.concatenate([groups[g], rs.randint(
                0, 250, 2 + (g + rnd) % 3).astype(np.int32)])
            reqs.append(srv.submit(p, 3))
            _inline(srv, reqs[-1:])
    _finish(srv)
    return reqs


MODES = {
    "plain": (_plain, dict(max_seq_len=64, pipeline_depth=2)),
    "cache_mixed": (_cache_mixed, dict(max_seq_len=64, kvcache=True,
                                       mixed=True, chunk_tokens=16,
                                       pipeline_depth=2)),
    "spec": (_spec, dict(max_seq_len=128, spec=True, spec_k=8,
                         pipeline_depth=2)),
    "priority": (_priority, dict(max_seq_len=64, num_pages=12,
                                 priority=True, kvcache=True,
                                 pipeline_depth=1)),
    "tier": (_tier, dict(max_seq_len=64, num_pages=9, kvcache=True,
                         kvtier=True, host_pages=32, pipeline_depth=1)),
}


def _samples(obs):
    """name -> {labels: value} of the side's registry, unported planes
    left out."""
    got = obs.parse_prometheus(obs.render_prometheus(obs.REGISTRY))
    return {k: v for k, v in got.items() if not k.startswith(UNPORTED)}


def _comparable(samples):
    """The values that do not depend on host timing: counters, gauges and
    the ``_count`` of histograms and sketches (not ``_sum``, buckets or
    quantiles)."""
    out = {}
    for name, series in samples.items():
        if name.endswith(("_sum", "_bucket")):
            continue
        for labels, v in series.items():
            if any(k == "quantile" for k, _ in labels):
                continue
            out[(name, labels)] = v
    return out


def _kinds(fl, reqs):
    evs = fl.ring().events() if fl.ring() is not None else []
    return [[e["kind"] for e in evs if e.get("request") == r.id]
            for r in reqs]


@pytest.mark.parametrize("mode", list(MODES))
def test_instruments_match_jax(pair, planes, mode):
    jm, tm = pair
    drive, kw = MODES[mode]
    kw = dict(kw, max_batch=2, page_size=PAGE, slo=True)
    ref = JServer(jm, ragged_prefill=True, **kw)
    want = drive(ref, jrc)
    srv = LLMServer(tm, device="cpu", **kw)
    got = drive(srv, trc)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert srv.errors == []
    js, ts = _samples(jobs), _samples(tobs)
    assert {n: set(s) for n, s in ts.items()} == \
        {n: set(s) for n, s in js.items()}
    assert _comparable(ts) == _comparable(js)
    kinds = _kinds(tflight, got)
    assert kinds == _kinds(jflight, want)
    assert all(k[0] == "queue" and k[-1] == "finish" for k in kinds)
    assert "bigdl_slo_requests_total" in ts
    assert sum(ts["bigdl_llm_requests_total"].values()) == len(got)
    if mode == "plain":
        # the request submitted under a trace has its spans stitched
        spans = [{s["name"] for s in obs.TRACE.for_trace("c" * 32)}
                 for obs in (jobs, tobs)]
        assert spans[0] == spans[1] >= {"llm/queue_wait", "llm/prefill",
                                        "llm/decode"}
    assert {"spec": "bigdl_llm_spec_passes_total",
            "priority": "bigdl_llm_preemptions_total",
            "tier": "bigdl_kvtier_spills_total",
            "cache_mixed": "bigdl_llm_pass_rows_total",
            "plain": "bigdl_llm_decode_tokens_total"}[mode] in ts
    ref.stop()
    srv.stop()


@pytest.mark.parametrize("mode,site", [
    ("cache_mixed", "llm.chunk"), ("spec", "llm.spec"),
    ("priority", "llm.preempt"), ("tier", "kvcache.evict"),
    ("tier", "kvtier.spill"), ("tier", "kvtier.fetch")])
def test_fault_sites_fire_alike(pair, planes, mode, site):
    """A seeded raise at each engine fault site fires at the same call in
    both engines and is handled alike: the same tokens, the same failed
    requests with the same messages, the same injected-fault series."""
    jm, tm = pair
    drive, kw = MODES[mode]
    kw = dict(kw, max_batch=2, page_size=PAGE)
    out = []
    for server, rel, obs, rc, extra in (
            (JServer, jrel, jobs, jrc, dict(ragged_prefill=True)),
            (LLMServer, trel, tobs, trc, dict(device="cpu"))):
        plan = rel.FaultPlan(seed=0).add(site, "raise", after=1, times=1)
        rel.set_plan(plan)
        try:
            srv = server(jm if server is JServer else tm, **kw, **extra)
            reqs = drive(srv, rc)
        finally:
            rel.set_plan(None)
        out.append(([r.tokens for r in reqs],
                    [r.error.replace(r.id, "") if r.error else None
                     for r in reqs], plan.fired,
                    _samples(obs)["bigdl_reliability_injected_faults_total"]))
        srv.stop()
    assert out[0] == out[1]
    assert out[1][2] == [(site, "raise")]


def _warm(server_cls, model, prompts, **kw):
    srv = server_cls(model, **kw).start()
    for r in [srv.submit(p, 4) for p in prompts]:
        r.get(timeout=300)
    srv.stop()


def _stall(server_cls, model, rel, prompts, **kw):
    """Two requests decoding, then a stall of 4x the timeout at
    ``worker.stall``: trips, failed requests, their errors, and a request
    served after the engine recovered."""
    srv = server_cls(model, watchdog_timeout=0.25, **kw)
    plan = rel.FaultPlan(seed=0).add("worker.stall", "delay", after=3,
                                     times=1, delay=1.0)
    reqs = [srv.submit(p, 40) for p in prompts]
    rel.set_plan(plan)
    srv.start()
    try:
        for r in reqs:
            r.done.wait(30)
        t_fail = time.monotonic()
        tripped = srv.watchdog_tripped
        # the pass wakes after its stall: the heartbeat clears the trip
        while srv.watchdog_tripped and time.monotonic() - t_fail < 10:
            time.sleep(0.02)
        after = srv.submit(prompts[0], 4).get(timeout=60)
    finally:
        rel.set_plan(None)
        srv.stop()
    return (tripped, srv.watchdog_trips, srv.watchdog_tripped,
            [r.error for r in reqs], [r.cancel_requested for r in reqs],
            plan.fired, after)


def test_watchdog_matches_jax(pair, planes):
    jm, tm = pair
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 250, n).astype(np.int32) for n in (6, 11)]
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE)
    # the JAX engine compiles its steps at first use: warm them first,
    # or the compile trips the watchdog
    _warm(JServer, jm, prompts, ragged_prefill=True, **kw)
    want = _stall(JServer, jm, jrel, prompts, ragged_prefill=True, **kw)
    got = _stall(LLMServer, tm, trel, prompts, device="cpu", **kw)
    assert got == want
    tripped, trips, _, errors, *_ = got
    assert tripped and trips == 1
    assert errors[0].startswith("engine stalled") and "retriable" in \
        errors[0]
    for obs in (jobs, tobs):
        assert _samples(obs)["bigdl_llm_watchdog_trips_total"] == {(): 1.0}


def _step_fault(server_cls, model, rel, prompts, **kw):
    srv = server_cls(model, **kw)
    reqs = [srv.submit(p, 8) for p in prompts]
    plan = rel.FaultPlan(seed=0).add("llm.step", "raise", after=3, times=1)
    rel.set_plan(plan)
    srv.start()
    try:
        toks = [r.get(timeout=120) for r in reqs]
    finally:
        rel.set_plan(None)
        srv.stop()
    return toks, plan.fired


def test_injected_step_raise_is_retried(pair, planes):
    """An ``InjectedFault`` at ``llm.step`` is retried (counted, backed
    off, slots kept): the tokens equal a fault-free run in both
    engines."""
    jm, tm = pair
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 250, n).astype(np.int32) for n in (7, 13)]
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE)
    clean = [list(map(int, jm.generate(p[None], max_new_tokens=8)
                      [0, len(p):])) for p in prompts]
    want = _step_fault(JServer, jm, jrel, prompts, ragged_prefill=True, **kw)
    got = _step_fault(LLMServer, tm, trel, prompts, device="cpu", **kw)
    assert got == want == (clean, [("llm.step", "raise")])
    retries = {(("component", "llm_server"),): 1.0}
    for obs in (jobs, tobs):
        assert _samples(obs)["bigdl_reliability_retries_total"] == retries


def test_other_failures_still_fail_in_flight(pair, planes):
    """A real (not injected) error fails the requests in flight: a CUDA
    error is sticky, so the port does not retry it."""
    _, tm = pair
    srv = LLMServer(tm, max_batch=2, max_seq_len=64, device="cpu")
    srv._step_paged = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    req = srv.submit(np.arange(1, 6, dtype=np.int32), 4)
    srv.start()
    try:
        assert req.done.wait(30) and "RuntimeError: boom" in req.error
    finally:
        srv.stop(drain=False)
    assert "bigdl_reliability_retries_total" not in _samples(tobs)


def test_env_turns_the_prefix_cache_on(pair, planes, monkeypatch):
    """``BIGDL_TPU_LLM_KVCACHE_ENABLED=true`` gives both engines a prefix
    cache, which the second serving of a prompt hits."""
    jm, tm = pair
    monkeypatch.setenv("BIGDL_TPU_LLM_KVCACHE_ENABLED", "true")
    p = np.random.RandomState(2).randint(0, 250, 20).astype(np.int32)
    hits = []
    for srv in (JServer(jm, max_batch=2, max_seq_len=64, page_size=PAGE,
                        ragged_prefill=True),
                LLMServer(tm, max_batch=2, max_seq_len=64, device="cpu")):
        assert srv._kv.enabled
        for _ in range(2):
            _inline(srv, [srv.submit(p, 3)])
            _finish(srv)
        hits.append(srv._kv.hits)
        srv.stop()
    assert hits[0] == hits[1] == 1


def test_overload_error_is_the_planes(pair, planes):
    _, tm = pair
    assert serving.OverloadError is trel.OverloadError
    srv = LLMServer(tm, max_batch=1, max_seq_len=64, max_queue=1,
                    device="cpu")
    srv.submit(np.arange(1, 6, dtype=np.int32), 2)
    with pytest.raises(trel.OverloadError) as e:
        srv.submit(np.arange(1, 6, dtype=np.int32), 2)
    assert e.value.pages_needed == 1 and "uncached suffix" in str(e.value)
    srv.begin_drain()
    with pytest.raises(trel.OverloadError) as e:
        srv.submit(np.arange(1, 6, dtype=np.int32), 2)
    assert e.value.draining
    shed = _samples(tobs)["bigdl_reliability_shed_total"]
    assert shed == {(("component", "llm_server"),): 2.0}
    srv.stop(drain=False)


def test_instruments_add_no_launches(pair, planes):
    """With observability on and off the engine dispatches the same
    steps: the instruments only read host values the drain has."""
    _, tm = pair
    from bigdl_tpu_torch.llm import kernels
    counts = []
    for on in (True, False):
        (tobs.enable if on else tobs.disable)()
        kernels.reset_launch_counts()
        srv = LLMServer(tm, max_batch=2, max_seq_len=64, device="cpu")
        _plain(srv, trc)
        counts.append((srv.steps, dict(kernels.launch_counts())))
        srv.stop()
    tobs.enable()
    assert counts[0] == counts[1]
