"""The port's router and failover primitives (``llm/failover.py``,
``LLMRouter``, ``llm/chaos.py``) against the JAX package's: the
primitives call for call, the prober, ``_pick`` and ``POST /backends``;
a port router over port workers against a JAX router over JAX workers
and over JAX workers; live failover and hedged decode bit-identical to
``generate`` (tiny Llama, f32 q4_0 weights and cache); the chaos drive."""

import contextlib
import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import observability as jobs
from bigdl_tpu import reliability as jrel
from bigdl_tpu.llm import failover as jfo
from bigdl_tpu.llm import worker as jworker
from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.llm.serving import LLMServer as JServer

from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch import reliability as trel
from bigdl_tpu_torch.llm import failover as tfo
from bigdl_tpu_torch.llm import worker as tworker
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer

PAGE = 8
KW = dict(max_batch=2, max_seq_len=64, page_size=PAGE)
TIER = dict(KW, kvcache=True, kvtier=True, host_pages=32)
SIDES = {"jax": (jfo, jworker, jrel, jobs),
         "torch": (tfo, tworker, trel, tobs)}
PROMPTS = [list(range(1, 21)), list(range(30, 45)), [7, 3, 9, 4, 1, 8]]
ROUTER_SERIES = ("bigdl_router_breaker_state", "bigdl_router_failovers_total",
                 "bigdl_router_hedges_total", "bigdl_router_journal_inflight",
                 "bigdl_router_backend_healthy")


@pytest.fixture(scope="module")
def fleet():
    """Per package: two decode workers over prefix-cache engines, and a
    prefill and a decode worker over host-tier engines, on the same tiny
    f32 q4_0 weights."""
    cfg = jllama.LlamaConfig.tiny()
    p = jllama.quantize_params(jllama.init_params(cfg, 0, dtype=jnp.float32),
                               "sym_int4")
    jm = jllama.LlamaForCausalLM(cfg, p, max_cache_len=128,
                                 cache_dtype=jnp.float32)
    tm = tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
        cache_dtype=torch.float32, page_size=PAGE, device="cpu")
    out, stop = {"model": jm, "tmodel": tm}, []
    for side, mk, wk in (
            ("jax", lambda **k: JServer(jm, ragged_prefill=True, **k),
             jworker.LLMWorker),
            ("torch", lambda **k: LLMServer(tm, device="cpu", **k),
             tworker.LLMWorker)):
        srvs = [mk(kvcache=True, **KW).start() for _ in range(2)]
        pre, dec = mk(**TIER).start(), mk(**TIER).start()
        ws = [wk(s, role="decode").start() for s in srvs]
        wp, wd = wk(pre, role="prefill").start(), wk(dec, role="decode").start()
        out[side] = {"decode": ws, "prefill": wp, "tier_decode": wd,
                     "servers": srvs}
        stop += ws + [wp, wd] + srvs + [pre, dec]
    yield out
    for x in stop:
        x.stop()


@pytest.fixture()
def faults_armed():
    """Reliability on in both packages for the test, plans cleared."""
    was = [r.enabled() for r in (jrel, trel)]
    for r in (jrel, trel):
        r.enable()
    yield
    for r, w in zip((jrel, trel), was):
        r.set_plan(None)
        if not w:
            r.disable()


def _req(addr, method, path, body=None, headers=None, timeout=60):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        payload = json.dumps(body) if body is not None else None
        conn.request(method, path, payload, dict(headers or {}))
        r = conn.getresponse()
        data = r.read().decode()
        try:
            data = json.loads(data)
        except ValueError:
            pass
        return r.status, data, {k.lower(): v for k, v in r.getheaders()}
    finally:
        conn.close()


def _golden(jm, ids, n):
    return [int(t) for t in jm.generate(np.asarray(ids, np.int32)[None],
                                        max_new_tokens=n)[0, len(ids):]]


@contextlib.contextmanager
def _routed(side, decode, prefill=(), **kw):
    kw.setdefault("start_prober", False)
    r = SIDES[side][1].LLMRouter(list(prefill), list(decode), **kw).start()
    try:
        yield r
    finally:
        r.stop()


def _gen(addr, ids, n, **kw):
    return _req(addr, "POST", "/worker_generate",
                {"prompt_ids": ids, "max_new_tokens": n}, **kw)


def _metrics(side, addr):
    return SIDES[side][3].parse_prometheus(_req(addr, "GET", "/metrics")[1])


def _decode(fleet, side):
    return [w.address for w in fleet[side]["decode"]]


BOTH = pytest.mark.parametrize("side", list(SIDES))


def _open(router, addr):
    b = router._breakers[addr]
    while b.state != "open":
        b.record_failure()


# ---------------------------------------------------------------------------
# the primitives, call for call
# ---------------------------------------------------------------------------

def _journal_calls(fo):
    j = fo.RequestJournal()
    ent = j.add([1, 2, 3], max_new_tokens=5, priority="batch")
    got = []
    for cum, base in (([10, 11], 0), ([10], 0), ([10, 11], 0),
                      ([12], 2), ([12, 13, 14], 2)):
        ent.drained(cum, base)
        got.append((list(ent.tokens), ent.remaining,
                    len(ent.token_times)))
    got.append(ent.resume_prompt())
    snap = [{k: v for k, v in s.items() if k != "age_s"}
            for s in j.snapshot()]
    j.record_failover(ent)
    j.complete(ent)
    return got + [snap, j.failovers, j.tokens_resumed, j.inflight(),
                  j.completed, j.snapshot()]


def _tracker_calls(fo):
    t = fo.LatencyTracker(maxlen=4)
    out = [t.quantile()]
    for v in (1.0, 2.0, 3.0, 4.0, 100.0, 0.5):
        t.record(v)
        out.append((len(t), t.quantile(0.95), t.quantile(0.0),
                    t.quantile(0.5)))
    return out


def _hedge_calls(fo):
    out = [fo.HedgePolicy(enabled=False).allow()]
    p = fo.HedgePolicy(enabled=True, budget=0.5)
    for _ in range(2):
        p.note_request()
    for _ in range(3):
        out.append(p.allow())
        p.note_hedge()
    t = fo.LatencyTracker()
    d = fo.HedgePolicy(enabled=True, min_delay_ms=50.0)
    out += [fo.HedgePolicy(enabled=True, delay_ms=7.0).delay_for(t),
            d.delay_for(t)]
    t.record(0.2)
    out.append(d.delay_for(t))
    return out


def _hedged_calls(fo):
    out = []
    out.append(fo.run_hedged(lambda c: "fast", lambda c: "h", delay=0.2))
    rel = threading.Event()
    seen = []

    def slow(c):
        seen.append(c)
        rel.wait(5.0)
        return "slow"

    out.append(fo.run_hedged(slow, lambda c: "hedge", delay=0.01))
    out.append(seen[0].cancelled)
    rel.set()

    def bad(c):
        raise RuntimeError("boom")

    def fatal(c):
        raise ValueError("403")

    def torn(c):
        time.sleep(0.1)
        raise RuntimeError("torn")

    for args in ((bad, lambda c: "x", 0.5, None),
                 (torn, fatal, 0.0, (ValueError,)),
                 (torn, fatal, 0.0, None)):
        try:
            fo.run_hedged(args[0], args[1], args[2], prefer=args[3])
        except Exception as e:  # noqa: BLE001
            out.append((type(e).__name__, str(e)))
    fired = []
    out.append(fo.run_hedged(lambda c: time.sleep(0.1) or "a",
                             lambda c: "b", delay=0.01,
                             on_hedge=lambda: fired.append(1))[1])
    out.append(fired)
    return out


def _canceller_calls(fo):
    class Conn:
        closed = False

        def close(self):
            self.closed = True

    out = []
    for cancel_first in (False, True):
        c, conn = fo.Canceller(), Conn()
        if cancel_first:
            c.cancel()
        c.attach(conn)
        out.append((conn.closed, c.cancelled))
        c.cancel()
        out.append((conn.closed, c.cancelled))
    return out


@pytest.mark.parametrize("calls", [_journal_calls, _tracker_calls,
                                   _hedge_calls, _hedged_calls,
                                   _canceller_calls])
def test_primitives_call_for_call(calls):
    assert calls(tfo) == calls(jfo)


def test_prober_live_dead_and_stalled(fleet):
    dead = ("127.0.0.1", 1)
    out = []
    for side in ("jax", "torch"):
        w = fleet[side]["decode"][0]
        seen = []
        prober = SIDES[side][0].HealthProber(
            lambda: [(w.address, "decode"), (dead, "decode")],
            timeout=2.0, on_probe=lambda a, r, h, b: seen.append(h))
        row = [prober.healthy(dead), prober.state(dead)]
        prober.probe_now()
        row += [prober.healthy(w.address), prober.healthy(dead),
                prober.state(w.address), prober.state(dead), list(seen),
                sorted(prober.states().values()), prober.probes]
        w.server.watchdog_tripped = True          # what a trip sets
        try:
            prober.probe_now()
            row += [prober.healthy(w.address), prober.state(w.address)]
        finally:
            w.server.watchdog_tripped = False
        prober.probe_now()
        prober.mark(dead, "draining")
        row += [prober.healthy(w.address), prober.state(dead)]
        prober.forget(dead)
        row.append(prober.healthy(dead))
        out.append(row)
    assert out[0] == out[1]
    assert out[1][6] == [True, False] and out[1][9:11] == [False, "stalled"]


# ---------------------------------------------------------------------------
# placement and membership, step for step
# ---------------------------------------------------------------------------

def _pick_steps(side):
    decode = [("127.0.0.1", 10_000 + i) for i in range(3)]
    out = []
    with _routed(side, decode) as r:
        a, b, c = decode
        _open(r, b)
        out.append([r._pick("decode") for _ in range(4)])
        out.append([r._pick("decode", exclude={a}),
                    r._pick("decode", exclude={a, c})])
        for addr in decode:
            _open(r, addr)
        out += [r._pick("decode"), r._pick("prefill"), r._healthz()]
    with _routed(side, decode[:1], failover=True) as r:
        added = ("127.0.0.1", 10_099)
        out.append(r._admin_backends({"action": "add", "role": "decode",
                                      "host": added[0], "port": added[1]}))
        with r._prober._lock:
            r._prober._status[added] = False
        out.append([r._pick("decode") for _ in range(2)])
        out.append(r._admin_backends({"action": "remove", "role": "decode",
                                      "host": "127.0.0.1", "port": 10_000}))
        out.append(decode[0] in r._breakers)
        for bad in ({"action": "remove", "role": "decode",
                     "host": added[0], "port": added[1]},
                    {"action": "nope", "role": "decode"},
                    {"action": "add", "role": "router"}):
            with pytest.raises(ValueError) as e:
                r._admin_backends(bad)
            out.append(str(e.value))
    return out


def test_pick_and_admin_step_for_step():
    got, want = _pick_steps("torch"), _pick_steps("jax")
    assert got == want
    assert got[0] == [("127.0.0.1", 10_000), ("127.0.0.1", 10_002)] * 2


# ---------------------------------------------------------------------------
# a port router over port workers against a JAX router over JAX workers
# ---------------------------------------------------------------------------

def _serve_both(fleet, paths, mode, n=5):
    """Each side's router over its own two decode workers: the bodies and
    status codes of a generate of each prompt and of ``paths`` (GET)."""
    out = {}
    for side in SIDES:
        with _routed(side, _decode(fleet, side), **mode) as r:
            row = [_gen(r.address, p, n)[:2] for p in PROMPTS[:2]]
            for path in paths:
                st, body, _ = _req(r.address, "GET", path)
                if isinstance(body, dict):
                    # address-keyed blocks compare by their values
                    body = {k: (sorted(map(str, v.values())) if k in (
                        "backends", "prober", "backend_states") else
                        sorted(v) if isinstance(v, dict) else v)
                            for k, v in body.items()
                            if k not in ("decode_pool", "journal")}
                row.append((st, body))
            out[side] = row + [(r.requests_routed, r.failovers,
                                r.hedges_issued)]
    return out


@pytest.mark.parametrize("mode", [{}, {"failover": True},
                                  {"failover": True, "slo": True}])
def test_router_against_jax_router(fleet, mode):
    out = _serve_both(fleet, ("/healthz", "/worker_get_status"), mode)
    assert out["torch"] == out["jax"]
    want = [_golden(fleet["model"], p, 5) for p in PROMPTS[:2]]
    assert [b["output_ids"] for _, b in out["torch"][:2]] == want
    for name in ROUTER_SERIES:
        if jobs.REGISTRY.get(name) is not None:
            t, j = tobs.REGISTRY.get(name), jobs.REGISTRY.get(name)
            assert (t.kind, t.help, t.labelnames) == \
                (j.kind, j.help, j.labelnames)


@pytest.mark.parametrize("method,path", [
    ("GET", "/fleet/status"), ("GET", "/fleet/autoscaler"),
    ("GET", "/metrics/query"), ("GET", "/fleet/timeline"),
    ("GET", "/alerts"), ("GET", "/v1/models"), ("GET", "/nope"),
    ("POST", "/backends"), ("POST", "/v1/completions"), ("POST", "/nope")])
def test_router_404s(fleet, method, path):
    out = []
    for side in SIDES:
        with _routed(side, _decode(fleet, side)[:1]) as r:
            out.append(_req(r.address, method, path,
                            {} if method == "POST" else None)[:2])
    assert out[0] == out[1] and out[1][0] == 404


def test_all_open_sheds_and_breaker_gauges():
    out = []
    dead = [("127.0.0.1", 1), ("127.0.0.1", 2)]
    for side in SIDES:
        with _routed(side, dead) as r:
            for a in dead:
                _open(r, a)
            st, body, hdrs = _gen(r.address, [1, 2], 2)
            hz = _req(r.address, "GET", "/healthz")[:2]
            m = _metrics(side, r.address)
            out.append((st, body, int(hdrs["retry-after"]) >= 1, hz,
                        m["bigdl_router_breaker_state"][
                            (("backend", "127.0.0.1:1"),)]))
    assert out[0] == out[1]
    assert out[1][0] == 503 and out[1][4] == 2.0


def test_fleet_switch_raises():
    """The fleet autoscaler is ported: without failover a fleet router
    raises the JAX router's ``ValueError`` naming failover."""
    for wk in (jworker, tworker):
        with pytest.raises(ValueError, match="failover.enabled"):
            wk.LLMRouter([], [("127.0.0.1", 1)], fleet=True)


def test_port_router_over_jax_workers(fleet):
    """The wire is the JAX package's: a port router drives JAX workers,
    blocking and with failover."""
    for mode in ({}, {"failover": True}):
        with _routed("torch", _decode(fleet, "jax"), **mode) as r:
            for p in PROMPTS:
                st, body, _ = _gen(r.address, p, 6)
                assert st == 200 and \
                    body["output_ids"] == _golden(fleet["model"], p, 6)


@BOTH
def test_two_stage_route(fleet, side):
    """Prefill on the prefill worker, its chain imported by the decode
    worker, then decode there: the same ids as the decode worker's
    engine admitting the prompt itself."""
    f = fleet[side]
    ids = list(range(40, 61))
    with _routed(side, [f["tier_decode"].address], [f["prefill"].address],
                 failover=True) as r:
        st, body, _ = _gen(r.address, ids, 5)
        status = _req(r.address, "GET", "/worker_get_status")[1]
    assert st == 200 and body["output_ids"] == _golden(fleet["model"], ids, 5)
    assert status["handoffs_routed"] == 1 and status["prefill_degraded"] == 0


def test_openai_gateway_on_the_router(fleet):
    out = []
    for side in SIDES:
        with _routed(side, _decode(fleet, side), failover=True,
                     api=True) as r:
            st, body, _ = _req(r.address, "POST", "/v1/completions",
                               {"prompt": PROMPTS[2], "max_tokens": 6})
            out.append((st, body["choices"], body["usage"]))
    assert out[0] == out[1]
    assert out[1][1][0]["token_ids"] == _golden(fleet["model"],
                                                PROMPTS[2], 6)
    assert out[1][2] == {"prompt_tokens": 6, "completion_tokens": 6,
                         "total_tokens": 12}


# ---------------------------------------------------------------------------
# failure paths: deadlines, timeout chunks, live failover, hedging
# ---------------------------------------------------------------------------

class _Stub:
    """A stub decode worker: ``mode="500"`` records each attempt's
    deadline header, burns 50 ms and fails; ``mode="timeout"`` answers a
    stream ending in a ``finish_reason: "timeout"`` chunk."""

    def __init__(self, mode):
        self.deadlines = []
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                stub.deadlines.append(self.headers.get(trel.DEADLINE_HEADER))
                if mode == "500":
                    time.sleep(0.05)
                    code, body = 500, b'{"error": "injected 500"}'
                else:
                    code, body = 200, (json.dumps(
                        {"output_ids": [], "done": True,
                         "finish_reason": "timeout"}) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.address = self.httpd.server_address
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@BOTH
def test_deadline_rederived_each_attempt(side):
    be = _Stub("500")
    try:
        with _routed(side, [be.address], failover=True, failover_attempts=3,
                     breaker_threshold=10) as r:
            st, _, _ = _gen(r.address, [1, 2], 2,
                            headers={trel.DEADLINE_HEADER: "5000"})
    finally:
        be.stop()
    got = [int(d) for d in be.deadlines]
    assert st == 502 and len(got) == 3
    assert got[0] <= 5000 and got[2] < got[1] < got[0]
    assert got[0] - got[2] >= 90


@BOTH
def test_timeout_chunk_fails_over(fleet, side):
    stub = _Stub("timeout")
    try:
        with _routed(side, [stub.address, _decode(fleet, side)[0]],
                     failover=True) as r:
            st, body, _ = _gen(r.address, PROMPTS[2], 4)
    finally:
        stub.stop()
    assert len(stub.deadlines) == 1 and r.failovers == 1
    assert st == 200 and body["output_ids"] == _golden(fleet["model"],
                                                       PROMPTS[2], 4)


@BOTH
def test_midstream_failover_resumes_bit_identical(fleet, side, faults_armed):
    rel = SIDES[side][2]
    with _routed(side, _decode(fleet, side), failover=True) as r:
        plan = rel.FaultPlan(seed=0)
        plan.add("router.dispatch", "raise", times=1, after=2)
        plan.add("llm.step", "delay", times=None, delay=0.03)
        rel.set_plan(plan)
        try:
            st, body, _ = _gen(r.address, PROMPTS[0], 6)
        finally:
            rel.set_plan(None)
        hz = _req(r.address, "GET", "/healthz")[1]
        m = _metrics(side, r.address)
    assert st == 200 and body["output_ids"] == _golden(fleet["model"],
                                                       PROMPTS[0], 6)
    assert r.failovers == 1 and r.tokens_resumed >= 1
    assert hz["failovers"] == 1 and hz["journal_inflight"] == 0
    assert m["bigdl_router_failovers_total"][(("stage", "decode"),)] >= 1


@BOTH
def test_hedged_decode_parity(fleet, side):
    servers = fleet[side]["servers"]
    with _routed(side, _decode(fleet, side), failover=True, hedge=True,
                 hedge_delay_ms=1.0) as r:
        st, body, _ = _gen(r.address, PROMPTS[1], 5)
        m = _metrics(side, r.address)
    assert st == 200 and body["output_ids"] == _golden(fleet["model"],
                                                       PROMPTS[1], 5)
    assert r.hedges_issued >= 1
    hedges = m["bigdl_router_hedges_total"]
    assert hedges[(("outcome", "issued"), ("stage", "decode"))] >= 1
    if side == "torch":     # the loser let go of its slot and pages
        deadline = time.monotonic() + 10
        while any(s.pages_in_use or any(s._slots) for s in servers):
            assert time.monotonic() < deadline, "a hedge loser kept pages"
            time.sleep(0.02)


def test_stalled_backend_leaves_the_pool(fleet):
    """A watchdog-tripped worker answers 503 "stalled": the prober marks
    it and ``_pick`` routes every request to the other backend."""
    ws = fleet["torch"]["decode"]
    ws[0].server.watchdog_tripped = True
    try:
        with _routed("torch", _decode(fleet, "torch"), failover=True,
                     prober_interval=0.05, start_prober=True) as r:
            deadline = time.monotonic() + 5
            while r._prober.healthy(ws[0].address):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            for p in PROMPTS:
                st, body, _ = _gen(r.address, p, 3)
                assert st == 200 and \
                    body["output_ids"] == _golden(fleet["model"], p, 3)
            hz = _req(r.address, "GET", "/healthz")[1]
    finally:
        ws[0].server.watchdog_tripped = False
    key = f"{ws[0].address[0]}:{ws[0].address[1]}"
    assert hz["prober"][key] is False and \
        hz["backend_states"][key] == "stalled"


def test_chaos_drive_loses_no_request(fleet):
    """The seeded kill storm; the drive first checks the disabled router:
    no journal, prober, hedge state, collector or SLO account, no such
    thread and no failover / hedge / SLO series from serving through
    it."""
    from bigdl_tpu_torch.llm.chaos import run_failover_chaos
    out = run_failover_chaos(fleet["tmodel"], seed=0, smoke=True)
    assert out["match"] and out["lost_requests"] == 0
    assert out["failovers"] >= 1 and out["tokens_resumed"] >= 1
