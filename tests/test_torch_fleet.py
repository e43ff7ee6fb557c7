"""The port's elastic fleet (``bigdl_tpu_torch/llm/fleet.py`` and its
wiring in ``llm/worker.py``) against the JAX package's: the engine's
drain primitives, ``DrainCoordinator``'s state machine and migration —
a port drain into a JAX worker's ``/worker_import_chain`` and the
reverse, the survivor serving the prefix it received — drain-aware
routing, scale-in under pipelining, ``FleetController`` on the same
fake router, provider and signal sequence as the JAX controller (the
same tick-by-tick decisions, events and ``status``), the autoscaler end
to end over ``LocalWorkerProvider`` engines, and the structural absence
of the disabled fleet. Tiny Llama, f32 q4_0 weights and cache, so
greedy ids equal the JAX ``generate``."""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import observability as jobs
from bigdl_tpu import reliability as jrel
from bigdl_tpu.llm import fleet as jfleet
from bigdl_tpu.llm import worker as jworker
from bigdl_tpu.llm.failover import HealthProber as JProber
from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.llm.serving import LLMServer as JServer
from bigdl_tpu.utils.conf import conf as jconf

from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch import reliability as trel
from bigdl_tpu_torch.llm import fleet as tfleet
from bigdl_tpu_torch.llm import worker as tworker
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.failover import HealthProber as TProber
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer
from bigdl_tpu_torch.utils.conf import conf as tconf

PAGE = 8
KW = dict(max_batch=2, max_seq_len=64, page_size=PAGE)
TIER = dict(KW, num_pages=24, kvcache=True, kvtier=True, host_pages=64)
SIDES = {"jax": (jfleet, jworker, jrel, jobs, jconf, JProber),
         "torch": (tfleet, tworker, trel, tobs, tconf, TProber)}
BOTH = pytest.mark.parametrize("side", list(SIDES))


@pytest.fixture(scope="module")
def models():
    cfg = jllama.LlamaConfig.tiny()
    p = jllama.quantize_params(jllama.init_params(cfg, 0, dtype=jnp.float32),
                               "sym_int4")
    jm = jllama.LlamaForCausalLM(cfg, p, max_cache_len=128,
                                 cache_dtype=jnp.float32)
    tm = tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
        cache_dtype=torch.float32, page_size=PAGE, device="cpu")
    return {"jax": jm, "torch": tm}


@pytest.fixture(autouse=True)
def _planes():
    """Both packages' host tiers inline, fault plans cleared, reliability
    on; everything put back after."""
    was = [r.enabled() for r in (jrel, trel)]
    for conf in (jconf, tconf):
        conf.set("bigdl.llm.kvtier.sync", "true")
    for r in (jrel, trel):
        r.enable()
    yield
    for conf in (jconf, tconf):
        conf.unset("bigdl.llm.kvtier.sync")
    for r, w in zip((jrel, trel), was):
        r.set_plan(None)
        if not w:
            r.disable()


def _mk(models, side, **kw):
    if side == "jax":
        return JServer(models["jax"], ragged_prefill=True, **kw)
    return LLMServer(models["torch"], device="cpu", **kw)


def _golden(models, p, n):
    return [int(t) for t in models["jax"].generate(
        np.asarray(p, np.int32)[None], max_new_tokens=n)[0, len(p):]]


def _ids(r):
    return [int(t) for t in r.get(timeout=300)]


def _req(addr, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"}
                     if body is not None else {})
        r = conn.getresponse()
        return r.status, json.loads(r.read().decode()), dict(r.getheaders())
    finally:
        conn.close()


def _wait(cond, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _status(w):
    st = dict(w._drain.status())
    st.pop("age_s")
    return st


# ---------------------------------------------------------------------------
# the engine's drain primitives and the drain coordinator
# ---------------------------------------------------------------------------

def test_engine_drain_and_warm_chains(models):
    """Drain / cancel / idle and ``warm_chains`` (maximal, whole pages)
    after the same requests: equal on both engines."""
    rs = np.random.RandomState(0)
    shared = rs.randint(0, 250, 16).astype(np.int32)
    p1 = np.concatenate([shared, rs.randint(0, 250, 8).astype(np.int32)])
    out = []
    for side in SIDES:
        rel = SIDES[side][2]
        srv = _mk(models, side, **TIER).start()
        try:
            trail = [srv.draining, srv.engine_idle()]
            srv.begin_drain()
            trail.append(srv.draining)
            with pytest.raises(rel.OverloadError, match="draining"):
                srv.submit(np.arange(6, dtype=np.int32), max_new_tokens=2)
            srv.cancel_drain()
            trail.append(srv.draining)
            trail += [_ids(srv.submit(p, max_new_tokens=2))
                      for p in (shared, p1)]
            out.append((trail, srv.warm_chains()))
        finally:
            srv.stop()
        assert _mk(models, side, **KW).warm_chains() == []
    assert out[0] == out[1]
    chains = [tuple(c) for c in out[1][1]]
    assert chains and all(len(c) % PAGE == 0 for c in chains)
    assert not [a for a in chains for b in chains
                if a != b and b[:len(a)] == a]


@pytest.mark.parametrize("src,dst", [("torch", "jax"), ("jax", "torch"),
                                     ("torch", "torch")])
def test_drain_migrates_chains_across_packages(models, src, dst):
    """A drain begun over ``POST /worker_drain`` migrates the warm chains
    into the survivor — a worker of either package — which then serves
    the prefix from them; the victim answers 503 draining meanwhile."""
    a = _mk(models, src, **TIER).start()
    b = _mk(models, dst, **TIER).start()
    wa = SIDES[src][1].LLMWorker(a, role="decode", fleet=True).start()
    wb = SIDES[dst][1].LLMWorker(b, role="decode", fleet=True).start()
    try:
        p = np.random.RandomState(1).randint(0, 250, 24).astype(np.int32)
        golden = _golden(models, p, 2)
        assert _ids(a.submit(p, max_new_tokens=2)) == golden
        st, body, _ = _req(wa.address, "POST", "/worker_drain",
                           {"action": "begin", "peers": [list(wb.address)],
                            "timeout": 30.0})
        assert st == 200 and body["state"] in ("draining", "migrating",
                                               "drained")
        assert _wait(lambda: wa._drain.status()["state"] == "drained")
        assert _status(wa) == {"state": "drained", "error": None,
                               "migrated_chains": 1, "migrated_pages": 3,
                               "failed_chains": 0}
        st, hz, _ = _req(wa.address, "GET", "/healthz")
        assert (st, hz["status"]) == (503, "draining")
        st, shed, _ = _req(wa.address, "POST", "/worker_generate",
                           {"prompt_ids": p.tolist(), "max_new_tokens": 2})
        assert st == 503 and shed.get("draining") is True
        assert b._tier.arena.used() == 3
        before = b._kv.prefix_tokens_reused
        assert _ids(b.submit(p, max_new_tokens=2)) == golden
        assert b._kv.prefix_tokens_reused - before == 16
        st, got, _ = _req(wa.address, "GET", "/worker_drain")
        assert st == 200 and got["state"] == "drained"
    finally:
        wa.stop()
        wb.stop()
        a.stop(drain=False)
        b.stop()


@BOTH
def test_drain_state_machine(models, side):
    """In-flight work finishes before the drain completes; a second begin
    is 409, a bad body 400; cancel resumes admission; a drain whose
    in-flight work outlives the timeout fails."""
    fleet, wk = SIDES[side][:2]
    srv = _mk(models, side, kvcache=True, **KW).start()
    w = wk.LLMWorker(srv, role="decode", fleet=True).start()
    try:
        p = np.arange(8, dtype=np.int32)
        r = srv.submit(p, max_new_tokens=12)
        assert w._drain.begin([], timeout=60.0)
        assert _req(w.address, "POST", "/worker_drain",
                    {"action": "begin"})[0] == 409
        assert _req(w.address, "POST", "/worker_drain",
                    {"peers": [["h"]]})[0] == 400
        assert _ids(r) == _golden(models, p, 12)
        assert _wait(lambda: w._drain.status()["state"] == "drained")
        st, body, _ = _req(w.address, "POST", "/worker_drain",
                           {"action": "cancel"})
        assert (st, body["state"], srv.draining) == (200, "cancelled",
                                                     False)
        assert len(_ids(srv.submit(p, max_new_tokens=1))) == 1
        busy = _Busy()
        dc = fleet.DrainCoordinator(busy)
        assert dc.begin([], timeout=0.05)
        assert _wait(lambda: not dc.active())
        assert (dc.status()["state"], busy.calls) == ("failed", ["begin"])
        assert dc.status()["error"] == \
            "in-flight requests did not finish within 0.05s"
        dc.cancel()
        assert (dc.status()["state"], busy.calls) == (
            "cancelled", ["begin", "cancel"])
    finally:
        w.stop()
        srv.stop()


class _Busy:
    """An engine whose accepted work never finishes."""

    def __init__(self):
        self.calls = []

    def begin_drain(self):
        self.calls.append("begin")

    def cancel_drain(self):
        self.calls.append("cancel")

    def engine_idle(self):
        return False


def test_worker_stop_during_active_drain(models):
    """Shutdown mid-migration joins the drain thread, orphans no post,
    leaves no arena slot pinned on either side and keeps admission
    closed; a ``worker.drain`` raise abandons one chain, never the
    drain."""
    a = _mk(models, "torch", **TIER).start()
    b = _mk(models, "torch", **TIER).start()
    wa = tworker.LLMWorker(a, role="decode", fleet=True).start()
    wb = tworker.LLMWorker(b, role="decode", fleet=True).start()
    try:
        rs = np.random.RandomState(2)
        for j in range(3):
            a.submit(rs.randint(0, 250, 16 + 8 * j).astype(np.int32),
                     max_new_tokens=2).get(timeout=300)
        plan = trel.FaultPlan(seed=0)
        plan.add("worker.drain", "raise", times=1)
        plan.add("worker.drain", "delay", times=None, delay=0.1)
        trel.set_plan(plan)
        assert wa._drain.begin([list(wb.address)], timeout=60.0)
        assert _wait(lambda: wa._drain.status()["migrated_chains"] >= 1,
                     timeout=10.0)
        wa.stop()
        assert not wa._drain.active()
        assert not [t for t in threading.enumerate()
                    if t.name == "bigdl-fleet-drain"]
        st = wa._drain.status()
        assert st["failed_chains"] == 1 and st["state"] == "cancelled"
        assert a._tier.arena.pinned() == 0 and b._tier.arena.pinned() == 0
        assert a.draining
    finally:
        trel.set_plan(None)
        wb.stop()
        a.stop(drain=False)
        b.stop()


# ---------------------------------------------------------------------------
# drain-aware routing and scale-in under pipelining
# ---------------------------------------------------------------------------

@BOTH
def test_drain_aware_routing(models, side):
    """The prober tells draining from dead; a draining backend bounces a
    dispatch to a live one without tripping its breaker or counting a
    failover; with every backend draining the router sheds 503 +
    Retry-After."""
    fleet, wk, _, _, _, prober_cls = SIDES[side]
    s1 = _mk(models, side, kvcache=True, **KW).start()
    s2 = _mk(models, side, kvcache=True, **KW).start()
    w1 = wk.LLMWorker(s1, role="decode", fleet=True).start()
    w2 = wk.LLMWorker(s2, role="decode", fleet=True).start()
    router = wk.LLMRouter([], [w1.address, w2.address], failover=True,
                          start_prober=False).start()
    dead = ("127.0.0.1", 1)
    a1 = tuple(w1.address)
    try:
        prober = prober_cls(lambda: [(a1, "decode"), (dead, "decode")],
                            interval=60.0)
        prober.probe_now()
        seen = [prober.state(a1), prober.state(dead)]
        s1.begin_drain()
        prober.probe_now()
        seen += [prober.state(a1), prober.healthy(a1)]
        prober.mark(a1, "ok")
        seen.append(prober.healthy(a1))
        assert seen == ["ok", "dead", "draining", False, True]
        p = list(range(10))
        st, body, _ = _req(router.address, "POST", "/worker_generate",
                           {"prompt_ids": p, "max_new_tokens": 3})
        assert st == 200 and body["output_ids"] == _golden(models, p, 3)
        assert router._breakers[a1].state == "closed"
        assert router.failovers == 0
        assert router._prober.state(a1) == "draining"
        s2.begin_drain()
        st, body, hdrs = _req(router.address, "POST", "/worker_generate",
                              {"prompt_ids": p, "max_new_tokens": 1})
        assert st == 503 and "Retry-After" in hdrs
    finally:
        router.stop()
        w1.stop()
        w2.stop()
        s1.stop(drain=False)
        s2.stop(drain=False)


def test_scale_in_under_pipelining(models):
    """A depth-4 engine drained with requests in flight, one of them
    fetching its prefix from the host arena: every answer is the JAX
    ``generate``'s, and the page / budget ledger returns to idle."""
    a = _mk(models, "torch", pipeline_depth=4, **TIER).start()
    b = _mk(models, "torch", **TIER).start()
    wa = tworker.LLMWorker(a, role="decode", fleet=True).start()
    wb = tworker.LLMWorker(b, role="decode", fleet=True).start()
    try:
        rs = np.random.RandomState(3)
        warm = rs.randint(0, 250, 24).astype(np.int32)
        others = [rs.randint(0, 250, 10 + 2 * j).astype(np.int32)
                  for j in range(2)]
        b.submit(warm, max_new_tokens=1).get(timeout=300)
        assert a.import_chain(b.export_chain(warm)) >= 1
        reqs = [a.submit(p, max_new_tokens=4) for p in others + [warm]]
        assert wa._drain.begin([list(wb.address)], timeout=60.0)
        for p, r in zip(others + [warm], reqs):
            assert _ids(r) == _golden(models, p, 4)
        assert _wait(lambda: wa._drain.status()["state"] == "drained")
        assert a._tier.fetches >= 1
        assert a.engine_idle() and not a._inflight
        assert a._budget_avail == TIER["num_pages"] - 1
        assert a._tier.arena.pinned() == 0
    finally:
        wa.stop()
        wb.stop()
        a.stop(drain=False)
        b.stop()


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------

class _FakeRouter:
    def __init__(self, addrs):
        self._pool_lock = threading.RLock()
        self.decode_workers = list(addrs)
        self._journal = self._prober = self._collector = None
        self.removed = []

    def _admin_backends(self, body):
        addr = (body["host"], int(body["port"]))
        if body["action"] == "add":
            self.decode_workers.append(addr)
        else:
            if len(self.decode_workers) == 1:
                raise ValueError("refusing to remove the last backend")
            self.decode_workers.remove(addr)
            self.removed.append(addr)
        return 200, {}


def _provider(fleet):
    class Fake(fleet.WorkerProvider):
        def __init__(self):
            self.launched, self.terminated, self.n = [], [], 0

        def launch(self):
            self.n += 1
            self.launched.append(("127.0.0.1", 40000 + self.n))
            return self.launched[-1]

        def terminate(self, addr):
            self.terminated.append(tuple(addr))
    return Fake()


def _sig(queue=0.0, active=0.0, sheds=None, occ=0.0, qi=0.0, parked=None):
    return lambda n: {"workers": n, "queue": queue, "active": active,
                      "inflight": 0, "sheds": sum((sheds or {}).values()),
                      "sheds_by": dict(sheds or {}), "occupancy_max": occ,
                      "queue_interactive": qi,
                      "parked_by": dict(parked or {}), "source": "fake"}


HOT, IDLE = _sig(queue=10.0, active=2.0), _sig()
SCENARIOS = {
    "sustain": (dict(sustain=3), [HOT] * 4),
    "cooldown_max": (dict(sustain=1, cooldown=3600.0, max_workers=2),
                     [HOT] * 4),
    "max_bound": (dict(sustain=1, max_workers=2), [HOT] * 4),
    "shed_delta": (dict(sustain=1), [
        _sig(active=1.0, sheds={"a": 100.0}),
        _sig(active=1.0, sheds={"a": 103.0}),
        _sig(active=1.0, sheds={"a": 2.0, "b": 7.0}),
        _sig(active=1.0, sheds={"a": 2.0, "b": 7.0})]),
    "occupancy_and_class": (dict(sustain=1, max_workers=4), [
        _sig(active=1.0, occ=0.95), _sig(active=1.0, qi=2.0),
        _sig(active=1.0, qi=2.0)]),
    "idle_min_bound": (dict(sustain=1), [IDLE] * 4),
    "scale_in_dead_victim": (dict(sustain=2, start=3), [
        IDLE, IDLE, _sig(parked={("127.0.0.1", 39002): 1.0}), IDLE, IDLE]),
    "scale_in_skips_parked": (dict(sustain=1, start=3), [
        _sig(parked={("127.0.0.1", 39002): 2.0})]),
    "flap": (dict(sustain=2), [HOT, IDLE, HOT, _sig(active=3.0), HOT, HOT]),
}


@pytest.mark.parametrize("provided", [True, False])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_ticks(name, provided):
    """Both controllers on the same fake router, provider and signal
    sequence: the same decision trace, actions, events and ``status``
    after every tick (a scale-in's drain POST meets a dead address and
    fails alike)."""
    opts, seq = SCENARIOS[name]
    opts = dict(opts)
    start = opts.pop("start", 1)

    def run(side):
        fleet = SIDES[side][0]
        router = _FakeRouter([("127.0.0.1", 39000 + i)
                              for i in range(start)])
        prov = _provider(fleet) if provided else None
        args = dict(min_workers=1, max_workers=3, interval=60.0,
                    cooldown=0.0, sustain=2, queue_high=1.0, idle_low=0.0,
                    drain_timeout=5.0)
        args.update(opts)
        fc = fleet.FleetController(router, provider=prov, **args)
        out = []
        for s in seq:
            fc.signals = lambda s=s: s(len(router.decode_workers))
            fc.tick()
            st = json.loads(json.dumps(fc.status()))
            for e in st["events"]:
                e.pop("ts")
                e.pop("error", None)
            out.append(st)
        return [out, fc.decisions, router.decode_workers, router.removed,
                prov and (prov.launched, prov.terminated)]
    want, got = run("jax"), run("torch")
    assert got == want


def test_controller_signals_from_snapshots_and_healthz(models):
    """``signals`` over a federated pool reads the members' snapshots
    (and ``/healthz`` for a member without one) as the JAX controller
    does."""
    out = []
    for side in SIDES:
        fleet, wk = SIDES[side][:2]
        srv = _mk(models, side, **KW).start()
        w = wk.LLMWorker(srv, role="decode").start()
        r = _FakeRouter([tuple(w.address)])

        class Coll:
            def snapshots(self):
                return {"router": {}, "127.0.0.1:1": {"metrics": [
                    {"name": "bigdl_llm_queue_depth",
                     "series": [{"value": 3.0}]}]}}
        try:
            fc = fleet.FleetController(r)
            a = fc.signals()
            r._collector = Coll()
            r.decode_workers.append(("127.0.0.1", 1))
            b = fc.signals()
            out.append((a, b, fleet.FleetController._from_snapshot(
                {"metrics": [{"name": n, "series": [
                    {"labels": ["interactive"], "value": 2.0}]}
                    for n in ("bigdl_llm_queue_depth",
                              "bigdl_llm_active_slots",
                              "bigdl_reliability_shed_total",
                              "bigdl_llm_kv_pool_occupancy",
                              "bigdl_llm_queue_depth_class",
                              "bigdl_llm_preempt_parked")]})))
        finally:
            w.stop()
            srv.stop()
    for o in out:
        for sig in o[:2]:
            sig["parked_by"] = {k[0]: v for k, v in
                                sig["parked_by"].items()}
            sig["sheds_by"] = {}
    a, b = out
    assert a[2] == b[2] and a[0]["source"] == b[0]["source"] == "healthz"
    assert a[1]["queue"] == b[1]["queue"] == 3.0


def test_autoscaler_end_to_end(models):
    """Spike → scale-out → idle → graceful drain → remove + terminate →
    one engine again, over the port's ``LocalWorkerProvider`` engines;
    every answer is the JAX ``generate``'s."""
    provider = tfleet.LocalWorkerProvider(
        models["torch"], server_kwargs=dict(device="cpu", kvcache=True,
                                            max_queue=8, **KW))
    router = None
    try:
        seed_addr = provider.launch()
        p = list(range(10))
        golden = _golden(models, p, 2)
        router = tworker.LLMRouter(
            [], [seed_addr], failover=True, start_prober=False,
            fleet=True, provider=provider, start_fleet=False,
            fleet_opts=dict(min_workers=1, max_workers=2, interval=0.05,
                            cooldown=0.0, sustain=1, queue_high=0.5,
                            idle_low=0.0, drain_timeout=20.0)).start()
        fleet = router._fleet
        results = []

        def call():
            results.append(_req(router.address, "POST", "/worker_generate",
                                {"prompt_ids": p, "max_new_tokens": 2}))
        threads = [threading.Thread(target=call, daemon=True)
                   for _ in range(6)]
        for t in threads:
            t.start()
        assert _wait(lambda: fleet.tick() or
                     len(router.decode_workers) >= 2)
        for t in threads:
            t.join(timeout=600)
        assert [(st, b["output_ids"]) for st, b, _ in results] == \
            [(200, golden)] * 6
        assert _wait(lambda: fleet.tick() or (
            fleet.scale_ins >= 1 and len(router.decode_workers) == 1),
            timeout=60.0)
        assert provider.terminations >= 1
        st, status, _ = _req(router.address, "GET", "/fleet/autoscaler")
        assert st == 200 and status["scale_outs"] >= 1
        assert status["scale_ins"] >= 1 and status["provider"] == \
            "LocalWorkerProvider"
        assert [e["action"] for e in status["events"]
                if e["action"] in ("scale_out", "scale_in")][:2] == \
            ["scale_out", "scale_in"]
        hz = _req(router.address, "GET", "/healthz")[1]
        assert hz["fleet"]["workers"] == 1
    finally:
        if router is not None:
            router.stop()
        provider.stop_all()


def test_router_stop_cancels_inflight_scale_in(models):
    provider = tfleet.LocalWorkerProvider(
        models["torch"], server_kwargs=dict(device="cpu", **KW))
    router = None
    try:
        a1, a2 = provider.launch(), provider.launch()
        router = tworker.LLMRouter(
            [], [a1, a2], failover=True, start_prober=False, fleet=True,
            provider=provider, start_fleet=False,
            fleet_opts=dict(min_workers=1, max_workers=2, interval=0.05,
                            cooldown=0.0, sustain=1,
                            drain_timeout=30.0)).start()
        fleet = router._fleet
        victim = provider.servers()[a2]
        r = victim.submit(np.arange(6, dtype=np.int32), max_new_tokens=10)
        fleet._begin_scale_in(fleet.signals())
        assert fleet._draining is not None
        router.stop()
        router = None
        assert fleet._draining is None
        r.get(timeout=300)
        assert _wait(lambda: not victim.draining, timeout=10.0)
        assert not [t for t in threading.enumerate()
                    if t.name == "bigdl-fleet-drain"]
        victim.submit(np.arange(6, dtype=np.int32),
                      max_new_tokens=1).get(timeout=300)
    finally:
        if router is not None:
            router.stop()
        provider.stop_all()


@BOTH
def test_structural_absence(models, side):
    """Fleet off (the default): no drain, no controller, no thread, no
    ``bigdl_fleet_*`` series and the JAX 404s; a fleet router without
    failover raises naming failover."""
    fleet, wk, _, obs, conf, _ = SIDES[side]
    assert conf.get_bool("bigdl.llm.fleet.enabled", False) is False
    assert fleet.fleet_enabled() is False and fleet.fleet_enabled(True)
    srv = _mk(models, side, **KW).start()
    w = wk.LLMWorker(srv, role="decode").start()
    before = set(obs.render().splitlines())
    router = wk.LLMRouter([], [w.address], failover=True,
                          start_prober=False).start()
    try:
        assert w._drain is None and router._fleet is None
        got = [_req(w.address, "GET", "/worker_drain")[:2],
               _req(w.address, "POST", "/worker_drain",
                    {"action": "begin"})[:2],
               _req(router.address, "GET", "/fleet/autoscaler")[:2]]
        assert got == [(404, {"error": "fleet disabled"})] * 3
        st, body, _ = _req(router.address, "POST", "/worker_generate",
                           {"prompt_ids": list(range(6)),
                            "max_new_tokens": 2})
        assert st == 200
        grown = "\n".join(set(obs.render().splitlines()) - before)
        assert "bigdl_fleet_" not in grown
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("bigdl-fleet")]
        assert "fleet" not in _req(router.address, "GET", "/healthz")[1]
        with pytest.raises(ValueError, match="failover"):
            wk.LLMRouter([], [w.address], failover=False, fleet=True)
    finally:
        router.stop()
        w.stop()
        srv.stop()
