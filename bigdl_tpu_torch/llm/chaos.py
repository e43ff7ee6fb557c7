"""The chaos drives of the serving stack — the port of the JAX
package's ``tools/chaos_check.py`` modes ``--failover``, ``--alerts``
and ``--fleet``. Each builds its own engines, workers and router in
this process, arms seeded faults, and raises ``AssertionError`` when
its contract breaks; each returns its report.

- :func:`run_failover_chaos`: two decode workers behind a
  failover-enabled :class:`~bigdl_tpu_torch.llm.worker.LLMRouter`;
  seeded ``router.dispatch`` raises tear the router → worker stream
  after tokens drained, and a seeded ``worker.stall`` wedges one engine
  past its watchdog. Every request must still complete with greedy
  output equal to ``model.generate``, the journal resuming ``prompt +
  generated_so_far`` on the surviving backend, and the router's SLO
  sketches must count each token once. The disabled router is checked
  first: no journal, no prober, no collector thread, no failover /
  hedge / SLO series.
- :func:`run_alerts_chaos`: the time-series plane and the alert engine
  under a failover storm (the plane, when off, structurally absent; a
  fast-burn rule firing on the first sample after the storm, holding,
  resolving, and reconciling exactly with the flight events and the
  transition counters; the autoscaler's shed-pressure replay).
- :func:`run_fleet_chaos`: the elastic fleet under a closed-loop load
  with a worker killed mid-drain (zero lost requests, greedy outputs
  equal to the reference, a drained worker's chains serving prefix hits
  on the survivor, convergence to ``min`` workers, the disabled fleet's
  absence).

    from bigdl_tpu_torch.llm.chaos import run_failover_chaos
    run_failover_chaos(device="cpu", smoke=True)

    python -m bigdl_tpu_torch.llm.chaos --failover | --alerts | --fleet \\
        [--smoke] [--seed N] [--device cpu]

The CPU holds the resumed output bit for bit to ``generate`` (f32
weights and cache by default). On the card a resumed suffix is
prefilled where the first backend decoded it, so bf16 sums may part:
there hold it to the surviving engine's own answer, as ``chip_smoke.py``
phase 12 does and as :func:`run_fleet_chaos` does on the card (each
prompt served alone by one engine of the pool's settings).
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
from typing import Optional

import numpy as np


def _post(addr, path, body, timeout=600):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read().decode())
    finally:
        conn.close()


def _get(addr, path, timeout=60):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read().decode())
    finally:
        conn.close()


class _ConfKeys:
    """Set conf keys for a drive and put each back (or unset it) after."""

    def __init__(self, keys):
        from bigdl_tpu_torch.utils.conf import conf
        self.conf = conf
        with conf._lock:
            self.prev = {k: conf._set_layer.get(k) for k in keys}

    def restore(self):
        for k, v in self.prev.items():
            if v is None:
                self.conf.unset(k)
            else:
                self.conf.set(k, v)


def tiny_model(device=None):
    """The drive's model: the ``tiny`` Llama config, f32 weights from
    seed 0 and an f32 cache on ``device``."""
    import torch

    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM,
                                                  init_params)
    dev = resolve_device(device)
    cfg = LlamaConfig.tiny()
    return LlamaForCausalLM(cfg, init_params(cfg, 0, torch.float32,
                                             device=dev),
                            max_cache_len=128, cache_dtype=torch.float32,
                            page_size=8, device=dev)


def _serve_kw(model, **extra):
    """The drives' engine settings (the JAX drives' on :func:`tiny_model`,
    whose page is their 8 tokens; another model keeps its own page)."""
    return dict(max_batch=2, max_seq_len=64, device=model.device, **extra)


def run_failover_chaos(model=None, seed: int = 0, n_requests: int = 4,
                       kills: int = 2, stalls: int = 1,
                       new_tokens: int = 5, smoke: bool = False,
                       device=None, watchdog_timeout: float = 0.6,
                       stall_s: float = 1.5,
                       step_delay: Optional[float] = 0.02) -> dict:
    """A kill storm against the router must cost latency, not answers
    (module docstring). ``model`` defaults to :func:`tiny_model` on
    ``device``. ``smoke=True`` shrinks the storm to one kill over two
    requests. Returns the drive's report; raises ``AssertionError`` on a
    lost request, a divergence, a storm that fired no failover or
    resumed no token, or SLO counts off by a token."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch import reliability as rel
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker

    if smoke:
        n_requests = min(n_requests, 2)
        kills = min(kills, 1)
        new_tokens = min(new_tokens, 4)
    if model is None:
        model = tiny_model(device)
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, 250, 10 + 2 * j).astype(np.int32)
               for j in range(n_requests)]
    want = [list(map(int, model.generate(p[None],
                                         max_new_tokens=new_tokens)
                     [0, len(p):]))
            for p in prompts]
    kw = _serve_kw(model)

    # --- disabled-mode structural absence (serves one request)
    s0 = LLMServer(model, **kw).start()
    w0 = LLMWorker(s0, role="decode").start()
    before = set(obs.render().splitlines()) if obs.enabled() else set()
    r0 = LLMRouter([], [w0.address], start_prober=False).start()
    try:
        assert r0._journal is None and r0._prober is None \
            and r0._hedge is None, "disabled router built failover state"
        assert not s0.watchdog_enabled and s0._watchdog_thread is None
        st, body = _post(r0.address, "/worker_generate",
                         {"prompt_ids": [int(t) for t in prompts[0]],
                          "max_new_tokens": 2})
        assert st == 200, body
        if obs.enabled():
            new = "\n".join(set(obs.render().splitlines()) - before)
            for name in ("bigdl_router_failovers_total",
                         "bigdl_router_hedges_total",
                         "bigdl_router_journal_inflight",
                         "bigdl_router_backend_healthy",
                         "bigdl_llm_ttft_seconds",
                         "bigdl_llm_itl_seconds",
                         "bigdl_router_ttft_seconds",
                         "bigdl_router_itl_seconds",
                         "bigdl_slo_requests_total",
                         "bigdl_slo_burn_rate"):
                assert name not in new, \
                    f"disabled mode grew metric series {name}"
        assert s0._slo is None and r0._slo is None, \
            "disabled mode built an SLO account"
        assert r0._collector is None, \
            "disabled mode built a federation collector"
        assert not [t for t in threading.enumerate()
                    if t.name in ("bigdl-router-prober",
                                  "bigdl-federation-collector")], \
            "disabled mode started a prober/collector thread"
    finally:
        r0.stop()
        w0.stop()
        s0.stop()

    # --- the storm: kills mid-stream + a watchdog-tripping stall
    was_enabled = rel.enabled()
    if not was_enabled:
        rel.enable()
    s1 = LLMServer(model, kvcache=True, watchdog_timeout=watchdog_timeout,
                   slo=True, **kw)
    s2 = LLMServer(model, kvcache=True, watchdog_timeout=watchdog_timeout,
                   slo=True, **kw)
    # warm every shape the storm hits on both engines before the
    # watchdog is armed: the second submit of a prompt hits the radix
    # index the first seeded — the suffix-prefill shape every journal
    # resume uses. A first build or capture looks like a stalled pass.
    import torch
    for srv in (s1, s2):
        with torch.inference_mode():
            for p in prompts:
                for _ in range(2):
                    r = srv.submit(p, max_new_tokens=1)
                    while not r.done.is_set():
                        srv._admit()
                        srv._step()
            while srv._inflight:
                srv._drain_next()
        srv.start()
    w1 = LLMWorker(s1, role="decode").start()
    w2 = LLMWorker(s2, role="decode").start()
    router = LLMRouter([], [w1.address, w2.address], failover=True,
                       failover_attempts=8, start_prober=False,
                       slo=True).start()

    def _slo_counts():
        if not obs.enabled():
            return None
        reg = obs.REGISTRY
        classified = sum(
            reg.sample_value("bigdl_slo_requests_total", slo="ttft",
                             verdict=v, scope="router") or 0.0
            for v in ("ok", "violated"))
        return {
            "ttft": reg.sample_value("bigdl_router_ttft_seconds") or 0.0,
            "itl": reg.sample_value("bigdl_router_itl_seconds") or 0.0,
            "classified": classified}

    slo_before = _slo_counts()
    try:
        plan = rel.FaultPlan(seed=seed)
        # mid-stream connection kills: each bounded raise tears the
        # router->worker stream a few drained chunks in (llm.step is
        # slowed so chunks arrive one token at a time, and the dispatch
        # site fires once per drained chunk)
        for k in range(kills):
            plan.add("router.dispatch", "raise", times=1, after=3 + 2 * k)
        # a wedged step longer than the watchdog: the victim engine
        # trips mid-generation, fails its requests retriably, recovers
        plan.add("worker.stall", "delay", times=stalls, after=2,
                 delay=stall_s)
        if step_delay:
            plan.add("llm.step", "delay", times=None, delay=step_delay)
        rel.set_plan(plan)
        got, failures = [], []
        try:
            for j, p in enumerate(prompts):
                st, body = _post(router.address, "/worker_generate",
                                 {"prompt_ids": [int(t) for t in p],
                                  "max_new_tokens": new_tokens})
                if st != 200:
                    failures.append((j, st, body.get("error")))
                    got.append(None)
                else:
                    got.append(body["output_ids"])
        finally:
            rel.set_plan(None)
            if not was_enabled:
                rel.disable()
        out = {
            "seed": seed,
            "requests": n_requests,
            "events_fired": [f"{s}:{a}" for s, a in plan.fired],
            "failovers": router.failovers,
            "tokens_resumed": router.tokens_resumed,
            "watchdog_trips": s1.watchdog_trips + s2.watchdog_trips,
            "lost_requests": len(failures),
            "match": got == want,
            "outputs": got,
        }
        if failures:
            raise AssertionError(
                f"failover chaos lost {len(failures)} request(s) "
                f"(fired: {out['events_fired']}): {failures}")
        if not any(s == "router.dispatch" for s, _ in plan.fired):
            raise AssertionError(
                "failover chaos armed but no router.dispatch kill "
                "fired — widen the kill windows")
        if router.failovers == 0:
            raise AssertionError(
                "failover chaos completed without a single failover — "
                "the kills landed outside the streams")
        if router.tokens_resumed == 0:
            raise AssertionError(
                "every failover restarted from scratch — no resume "
                "carried drained tokens")
        if got != want:
            raise AssertionError(
                f"failover chaos divergence (fired: "
                f"{out['events_fired']}): {got} vs {want}")
        # each request classified once; the router's ITL sketch holds
        # exactly tokens - 1 samples a request (a resume that
        # double-stamped its replayed prefix would inflate it)
        slo_after = _slo_counts()
        if slo_after is not None:
            ttft_n = slo_after["ttft"] - slo_before["ttft"]
            itl_n = slo_after["itl"] - slo_before["itl"]
            cls_n = slo_after["classified"] - slo_before["classified"]
            want_itl = sum(len(w) - 1 for w in want)
            out["slo_ttft_samples"] = ttft_n
            out["slo_itl_samples"] = itl_n
            if ttft_n != len(want) or itl_n != want_itl \
                    or cls_n != len(want):
                raise AssertionError(
                    f"SLO counts: ttft {ttft_n}, itl {itl_n}, classified "
                    f"{cls_n}; expected {len(want)}, {want_itl}, "
                    f"{len(want)} (resumed tokens counted once)")
        return out
    finally:
        router.stop()
        w1.stop()
        w2.stop()
        s1.stop()
        s2.stop()


def run_alerts_chaos(model=None, seed: int = 0, new_tokens: int = 3,
                     smoke: bool = False, device=None) -> dict:
    """The time-series plane and the alert engine under a seeded failover
    storm. ``model`` defaults to :func:`tiny_model` on ``device``.

    Part 1 — disabled mode is STRUCTURALLY absent. With
    ``bigdl.observability.timeseries.enabled`` off, ``acquire()`` builds
    nothing, no sampler thread exists, no ``bigdl_timeseries_*`` /
    ``bigdl_alerts_*`` series appears, and ``/metrics/query``,
    ``/fleet/timeline`` and ``/alerts`` all answer 404 naming the gate.

    Part 2 — plane ON with a tiny-window fast-burn rule installed through
    ``bigdl.observability.alerts.rules``: clean traffic keeps the rule
    inactive; a seeded storm (a mid-stream ``router.dispatch`` kill and
    ``llm.step`` delays pushing every request past the TTFT objective)
    must flip it to firing on the FIRST store sample after the storm,
    hold firing while the storm is inside both windows, and resolve once
    the windows drain past it under clean traffic. The transitions must
    reconcile EXACTLY with the flight ``alert_fire`` / ``alert_resolve``
    events and with the ``bigdl_alerts_transitions_total`` deltas.

    Part 3 — the autoscaler reads its shed-pressure signal through the
    store's :class:`~bigdl_tpu_torch.observability.timeseries.
    WindowedCounter`; replaying the summed-delta formula over a
    restart-free ``sheds_by`` trace must give the identical
    pressure / idle / action sequence (the per-member primitive only
    differs where a member restarts)."""
    from urllib.parse import quote

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch import reliability as rel
    from bigdl_tpu_torch.llm.fleet import FleetController
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker
    from bigdl_tpu_torch.observability import alerts, flight
    from bigdl_tpu_torch.observability import timeseries as ts
    from bigdl_tpu_torch.utils.conf import conf

    GATE = "bigdl.observability.timeseries.enabled"
    RULE = "chaos-fast-burn-ttft"
    keys = _ConfKeys((GATE, "bigdl.observability.timeseries.interval",
                      "bigdl.observability.alerts.rules",
                      "bigdl.observability.flight.enabled"))

    def _alert_events():
        r = flight.ring()
        evs = r.events() if r is not None else []
        return {"fire": sum(1 for e in evs if e["kind"] == "alert_fire"),
                "resolve": sum(1 for e in evs
                               if e["kind"] == "alert_resolve")}

    def _trans(state):
        if not obs.enabled():
            return 0.0
        return obs.REGISTRY.sample_value(
            "bigdl_alerts_transitions_total", rule=RULE,
            state=state) or 0.0

    out = {"seed": seed, "gate": GATE}
    try:
        # --- part 1: disabled mode is structurally absent ---------------
        conf.set(GATE, "false")
        assert not ts.enabled, f"{GATE}=false left the plane armed"
        lines_before = (set(obs.render().splitlines())
                        if obs.enabled() else set())
        assert ts.acquire() is None, \
            "acquire() built a store while the gate was off"
        for path in ("/metrics/query?series=bigdl_slo_requests_total"
                     "&window=60",
                     "/fleet/timeline?series=bigdl_slo_requests_total"):
            resp = ts.debug_endpoint(path)
            assert resp is not None and resp[0] == 404 \
                and resp[1].get("gate") == GATE, \
                f"{path} must 404 naming {GATE} while off, got {resp!r}"
        resp = alerts.debug_endpoint("/alerts")
        assert resp is not None and resp[0] == 404 \
            and resp[1].get("gate") == GATE, \
            f"/alerts must 404 naming {GATE} while off, got {resp!r}"
        assert not [t for t in threading.enumerate()
                    if t.name == ts.TimeSeriesStore.THREAD_NAME], \
            "disabled mode has a live sampler thread"
        if obs.enabled():
            grown = set(obs.render().splitlines()) - lines_before
            leaked = [g for g in grown
                      if "bigdl_timeseries" in g or "bigdl_alerts" in g]
            assert not leaked, \
                f"disabled mode grew time-series series: {leaked}"
        out["disabled_mode"] = "structurally absent"

        # --- part 2: the storm, plane + alert engine on -----------------
        conf.set(GATE, "true")
        # park the wall-clock sampler: every sample below is a manual
        # fake-clock tick, and a stray real-time sample would evict the
        # whole fake-clock ring through retention
        conf.set("bigdl.observability.timeseries.interval", "3600")
        conf.set("bigdl.observability.flight.enabled", "true")
        rules = [{"name": RULE, "kind": "burn_rate", "slo": "ttft",
                  "short": 6.0, "long": 12.0, "factor": 5.0}]
        conf.set("bigdl.observability.alerts.rules", json.dumps(rules))
        assert ts.enabled
        if model is None:
            model = tiny_model(device)
        rs = np.random.RandomState(seed)
        prompts = [rs.randint(0, 250, 10 + 2 * j).astype(np.int32)
                   for j in range(2 if smoke else 3)]

        was_enabled = rel.enabled()
        if not was_enabled:
            rel.enable()
        s1 = LLMServer(model, **_serve_kw(model, kvcache=True,
                                          slo=True)).start()
        s2 = LLMServer(model, **_serve_kw(model, kvcache=True,
                                          slo=True)).start()
        w1 = LLMWorker(s1, role="decode").start()
        w2 = LLMWorker(s2, role="decode").start()
        router = LLMRouter([], [w1.address, w2.address], failover=True,
                           failover_attempts=8, start_prober=False,
                           slo=True).start()
        try:
            st = ts.store()
            eng = alerts.engine()
            assert st is not None and eng is not None, \
                "plane on but acquire() built no store/engine"
            assert [r["name"] for r in eng.rules] == [RULE], \
                "declarative rules override did not replace built-ins"
            assert [t for t in threading.enumerate()
                    if t.name == ts.TimeSeriesStore.THREAD_NAME], \
                "plane on but no sampler thread"
            # warm every storm shape on both engines (a resume re-prefills
            # through the partial-prefill shape; a first build or capture
            # would smear real seconds into the TTFT the storm asserts)
            for srv in (s1, s2):
                for p in prompts:
                    srv.submit(p, max_new_tokens=1).get(timeout=600)
                    srv.submit(p, max_new_tokens=1).get(timeout=600)

            ev_before = _alert_events()
            tr_before = {s: _trans(s) for s in ("firing", "resolved")}

            walls = []     # each request's wall ms, for the messages

            def serve(p):
                t0 = time.perf_counter()
                stt, body = _post(router.address, "/worker_generate",
                                  {"prompt_ids": [int(t) for t in p],
                                   "max_new_tokens": new_tokens})
                walls.append(round((time.perf_counter() - t0) * 1e3, 1))
                assert stt == 200, body

            # clean phase: fast traffic, the rule must stay inactive
            st.sample_now(now=0.0)
            for p in prompts[:2]:
                serve(p)
            st.sample_now(now=2.0)
            st.sample_now(now=4.0)
            assert eng.firing() == [], \
                f"clean traffic fired {eng.firing()} (request walls " \
                f"{walls} ms)"

            # the storm: a mid-stream dispatch kill (failover resumes it)
            # and per-step delays pushing every TTFT past the 500 ms
            # objective on both the engine and the router scope
            plan = rel.FaultPlan(seed=seed)
            plan.add("router.dispatch", "raise", times=1, after=1)
            plan.add("llm.step", "delay", times=None, delay=0.6)
            rel.set_plan(plan)
            try:
                for p in prompts:
                    serve(p)
            finally:
                rel.set_plan(None)
            out["fired_at"] = st.sample_now(now=6.0)
            assert RULE in eng.firing(), \
                "fast-burn rule not firing on the first evaluation " \
                f"after the storm: {eng.status()}"
            out["events_fired"] = [f"{s}:{a}" for s, a in plan.fired]

            # live surfaces while firing (the HTTP arms default `now` to
            # the wall clock, so the windows reach back to the fake-clock
            # sample timestamps)
            stt, body = _get(w1.address, "/alerts")
            assert stt == 200 and RULE in body["firing"], body
            q = quote('bigdl_slo_requests_total{slo="ttft",'
                      'verdict="violated"}', safe="")
            stt, body = _get(router.address,
                             f"/metrics/query?series={q}&window=1e15"
                             "&fn=delta")
            assert stt == 200 and (body["value"] or 0) > 0, body
            stt, body = _get(router.address,
                             "/fleet/timeline?series="
                             "bigdl_slo_requests_total&window=1e15")
            assert stt == 200 and body["merged"], body
            if obs.enabled():
                assert (obs.REGISTRY.sample_value("bigdl_alerts_firing")
                        or 0) >= 1, "bigdl_alerts_firing gauge not set"

            # storm deltas still inside both windows: one clean sample
            # must NOT flap the alert off (the long window's job)
            serve(prompts[0])
            st.sample_now(now=8.0)
            assert RULE in eng.firing(), \
                "alert flapped off while the storm was in-window"

            # recovery: the windows drain past the storm; clean traffic
            # between the next ticks evaluates to zero burn
            st.sample_now(now=30.0)
            for p in prompts[:2]:
                serve(p)
            st.sample_now(now=32.0)
            assert eng.firing() == [], \
                f"alert did not resolve after recovery: {eng.status()} " \
                f"(request walls in order, ms: {walls})"
            rule_st = [r for r in eng.status()["rules"]
                       if r["name"] == RULE][0]
            assert rule_st["state"] == "resolved", rule_st

            # the reconciliation: transitions == flight events, EXACTLY
            ev_delta = {k: _alert_events()[k] - ev_before[k]
                        for k in ev_before}
            tr_delta = {s: _trans(s) - tr_before[s]
                        for s in ("firing", "resolved")}
            assert ev_delta == {"fire": 1, "resolve": 1}, \
                f"flight alert events off: {ev_delta}"
            if obs.enabled():
                assert tr_delta == {"firing": 1.0, "resolved": 1.0}, \
                    f"transition counters off: {tr_delta}"
                out["transitions"] = tr_delta
            out["alert_events"] = ev_delta
            out["sample_overhead_us"] = st.status()["sample_overhead_us"]
        finally:
            rel.set_plan(None)
            if not was_enabled:
                rel.disable()
            router.stop()
            w1.stop()
            w2.stop()
            s1.stop()
            s2.stop()

        # --- part 3: autoscaler decision identity -----------------------
        # one synthesized restart-free trace through (a) a live
        # FleetController reading the WindowedCounter primitive and (b) a
        # replay of the summed max(total - last, 0) formula: pressure /
        # idle / action must be IDENTICAL tick for tick
        class _StubRouter:
            def __init__(self):
                self._pool_lock = threading.Lock()
                self.decode_workers = [("stub", 1), ("stub", 2)]

        def _sig(sheds_by, queue, active, workers):
            return {"workers": workers, "queue": queue, "active": active,
                    "inflight": 0, "sheds": sum(sheds_by.values()),
                    "sheds_by": dict(sheds_by), "occupancy_max": 0.0,
                    "queue_interactive": 0.0, "parked_by": {}}

        trace = [
            _sig({"a:1": 0.0, "b:1": 0.0}, 0.0, 1.0, 2),
            _sig({"a:1": 2.0, "b:1": 0.0}, 0.0, 1.0, 2),  # sheds grew
            _sig({"a:1": 2.0, "b:1": 3.0}, 5.0, 1.0, 2),  # grew + queue
            _sig({"a:1": 2.0, "b:1": 3.0}, 0.0, 1.0, 2),  # flat
            _sig({"a:1": 2.0}, 0.0, 0.0, 1),              # b departs flat
            _sig({"a:1": 2.0}, 0.0, 0.0, 1),              # idle, n == min
        ]
        ctl = FleetController(_StubRouter(), min_workers=1,
                              max_workers=4, sustain=2, cooldown=0.0,
                              queue_high=2.0, idle_low=0.0)
        it = iter(trace)
        ctl.signals = lambda: next(it)
        for _ in trace:
            ctl.tick()
        legacy = []
        last_sum = None
        hot = cold = 0
        for sig in trace:
            total = sum(sig["sheds_by"].values())
            delta = 0.0 if last_sum is None \
                else max(total - last_sum, 0.0)
            last_sum = total
            n = sig["workers"]
            pressure = (sig["queue"] > ctl.queue_high * max(n, 1)
                        or delta > 0
                        or (n > 0 and sig["occupancy_max"] > 0.9)
                        or (ctl.pressure_interactive
                            and sig["queue_interactive"]
                            > ctl.queue_high))
            idle = (sig["queue"] + sig["active"]
                    + sig["inflight"]) <= ctl.idle_low
            if pressure:
                hot += 1
                cold = 0
            elif idle:
                cold += 1
                hot = 0
            else:
                hot = cold = 0
            action = "none"
            if pressure and hot >= ctl.sustain and n < ctl.max_workers:
                action = "scale_out"
                hot = 0
            elif idle and cold >= ctl.sustain and n > ctl.min_workers:
                action = "scale_in"
                cold = 0
            legacy.append({"shed_delta": delta, "pressure": pressure,
                           "idle": idle, "action": action})
        got = [{k: d[k] for k in ("shed_delta", "pressure", "idle",
                                  "action")} for d in ctl.decisions]
        if got != legacy:
            raise AssertionError(
                "autoscaler diverged from the summed shed-delta formula "
                f"on a restart-free trace:\n new={got}\n old={legacy}")
        assert [d["action"] for d in got].count("scale_out") == 1, got
        # where the primitive intentionally differs: a member restart is
        # a reset for THAT member (its post-restart count is the delta),
        # not a clamp that swallows every other member's sheds
        wc = ts.WindowedCounter()
        assert wc.observe({"m": 10.0}) == 0.0
        assert wc.observe({"m": 14.0}) == 4.0
        assert wc.observe({"m": 3.0}) == 3.0
        out["autoscaler_decisions"] = "identical"
    finally:
        keys.restore()
        ts.reset()
        alerts.reset()
    out["match"] = True
    return out


def _engine_answers(model, prompts, budgets, **server_kwargs) -> list:
    """Each prompt served alone by one engine of ``server_kwargs`` (the
    reference a card run holds a served pool to: on the card the
    engine's bf16 sums may part from ``generate``'s)."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    srv = LLMServer(model, **server_kwargs).start()
    try:
        return [list(map(int, srv.submit(p, max_new_tokens=b)
                         .get(timeout=600)))
                for p, b in zip(prompts, budgets)]
    finally:
        srv.stop()


def run_fleet_chaos(model=None, seed: int = 0, smoke: bool = False,
                    device=None) -> dict:
    """The elastic-fleet soak. A fleet-enabled router (autoscaler and
    graceful drain) over a :class:`~bigdl_tpu_torch.llm.fleet.
    LocalWorkerProvider` pool is driven by the closed-loop load generator
    (:func:`bigdl_tpu_torch.tools.loadgen.run_load`) through spike →
    scale-out → worker KILLED mid-drain → scale-in cycles, with a seeded
    mid-stream ``router.dispatch`` kill and ``worker.drain`` delays
    widening the drain windows. The contract:

    - **zero lost requests** across every phase (sheds retry, failures
      fail over, drains bounce — none of it reaches the client);
    - greedy outputs **identical** to the reference: ``model.generate``
      on the CPU; on the card, where the engine's bf16 sums may part from
      ``generate``'s, each prompt served alone by one engine of the
      pool's settings;
    - a gracefully drained worker's warm KV chains land on the survivor
      and serve **prefix hits** there (a chain only the drained worker
      held);
    - the pool **converges** back to ``min`` workers;
    - ``bigdl.llm.fleet.enabled`` off is structurally absent: no drain
      coordinator, no controller thread, no ``bigdl_fleet_*`` series,
      ``/worker_drain`` and ``/fleet/autoscaler`` answer 404.

    ``model`` defaults to :func:`tiny_model` on ``device``; ``smoke``
    shrinks the request counts (same phases, same assertions)."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch import reliability as rel
    from bigdl_tpu_torch.llm.fleet import LocalWorkerProvider
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker
    from bigdl_tpu_torch.tools.loadgen import gen_prompts, run_load
    from bigdl_tpu_torch.utils.conf import conf

    n_requests = 6 if smoke else 8
    if model is None:
        model = tiny_model(device)
    prompts = gen_prompts(n_requests, seed=seed, shared_prefix=16)
    budgets = [2 + 2 * (j % 2) for j in range(n_requests)]
    pool_kw = _serve_kw(model, num_pages=24, kvcache=True, kvtier=True,
                        host_pages=64, max_queue=8)
    reference = "engine" if model.device.type == "cuda" else "generate"
    if reference == "engine":
        want = _engine_answers(model, prompts, budgets, **pool_kw)
    else:
        want = [list(map(int, model.generate(p[None], max_new_tokens=b)
                         [0, len(p):]))
                for p, b in zip(prompts, budgets)]

    # --- disabled-mode structural absence (bigdl.llm.fleet.enabled off,
    # the default): no drain coordinator, endpoints 404, no controller
    # thread, no bigdl_fleet_* series
    s0 = LLMServer(model, **_serve_kw(model))
    w0 = LLMWorker(s0, role="decode").start()
    before = set(obs.render().splitlines()) if obs.enabled() else set()
    r0 = LLMRouter([], [w0.address], failover=True,
                   start_prober=False).start()
    try:
        assert w0._drain is None, "fleet-off worker built a drain"
        assert r0._fleet is None, "fleet-off router built a controller"
        st, _ = _get(w0.address, "/worker_drain", timeout=5)
        assert st == 404, f"/worker_drain answered {st} with fleet off"
        st, _ = _get(r0.address, "/fleet/autoscaler", timeout=5)
        assert st == 404, f"/fleet/autoscaler answered {st} fleet-off"
        if obs.enabled():
            grown = "\n".join(set(obs.render().splitlines()) - before)
            assert "bigdl_fleet_" not in grown, \
                f"fleet-off mode grew fleet series:\n{grown}"
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("bigdl-fleet")], \
            "fleet-off mode started a fleet thread"
    finally:
        r0.stop()
        w0.stop()
        s0.stop(drain=False)

    # --- the soak
    keys = _ConfKeys(("bigdl.llm.kvtier.sync",))
    conf.set("bigdl.llm.kvtier.sync", "true")   # inline migrations:
    was_enabled = rel.enabled()                 # deterministic spills
    if not was_enabled:
        rel.enable()
    provider = LocalWorkerProvider(model, server_kwargs=pool_kw)
    router = None
    plan = rel.FaultPlan(seed=seed)
    try:
        seed_addr = provider.launch()
        seed_srv = provider.servers()[seed_addr]
        # warm every served shape (full prefill buckets and the partial
        # suffix shapes that resumes and prefix hits use)
        for p, b in zip(prompts, budgets):
            seed_srv.submit(p, max_new_tokens=b).get(timeout=600)
            seed_srv.submit(p, max_new_tokens=b).get(timeout=600)
        router = LLMRouter(
            [], [seed_addr], failover=True, failover_attempts=8,
            start_prober=False, fleet=True, provider=provider,
            start_fleet=False, fleet_opts=dict(
                min_workers=1, max_workers=3, interval=0.05,
                cooldown=0.0, sustain=1, queue_high=1.0, idle_low=0.0,
                drain_timeout=20.0)).start()
        fleet = router._fleet

        def tick_until(cond, timeout):
            t0 = time.time()
            while time.time() - t0 < timeout:
                fleet.tick()
                if cond():
                    return True
                time.sleep(0.02)
            return False

        def pool_size():
            with router._pool_lock:
                return len(router.decode_workers)

        # one mid-stream connection kill (the journal-resume path) and
        # per-chain drain delays (widen the mid-drain kill window)
        plan.add("router.dispatch", "raise", times=1, after=6)
        plan.add("worker.drain", "delay", times=None, delay=0.05)
        rel.set_plan(plan)

        lost = 0
        results = {}

        def load_phase(name, qps):
            holder = {}

            def run():
                holder["res"] = run_load(router.address, prompts,
                                         max_new_tokens=budgets, qps=qps,
                                         concurrency=4)
            t = threading.Thread(target=run, daemon=True)
            t.start()
            scaled = tick_until(lambda: pool_size() >= 2, timeout=30.0)
            t.join(timeout=600)
            res = holder["res"]
            results[name] = {k: res[k] for k in
                             ("sent", "ok", "lost", "retries_503")}
            if not scaled:
                raise AssertionError(
                    f"fleet soak: the {name} phase never scaled the pool "
                    f"out (signals: {fleet.signals()})")
            if res["outputs"] != want:
                raise AssertionError(
                    f"fleet soak divergence in the {name} phase: "
                    f"{res['outputs']} vs {want}")
            return res["lost"]

        # phase A: a spike against one worker -> sustained queue
        # pressure -> scale-out; a seeded mid-stream kill fails over
        lost += load_phase("spike", qps=200.0)

        # phase B: idle -> scale-in begins -> KILL the victim mid-drain;
        # the controller must remove the corpse, losing nothing
        if not tick_until(lambda: fleet._draining is not None,
                          timeout=30.0):
            raise AssertionError(
                "fleet soak: idle pool never began a scale-in drain")
        victim = tuple(fleet._draining["addr"])
        deadline = time.time() + 10.0
        while time.time() < deadline:
            try:
                _st, body = _get(victim, "/worker_drain", timeout=5)
            except Exception:   # noqa: BLE001 — the victim went away
                break
            if body.get("state") in ("migrating", "drained"):
                break
            time.sleep(0.01)
        provider.kill(victim)
        if not tick_until(lambda: fleet._draining is None, timeout=30.0):
            raise AssertionError(
                "fleet soak: the controller never resolved the "
                "killed-mid-drain worker")
        if fleet.drains_lost < 1:
            raise AssertionError(
                "fleet soak: the mid-drain kill was not observed as a "
                f"lost drain (events: {fleet.events[-8:]})")

        # phase C: spike again -> scale out; plant a chain ONLY the new
        # worker holds; idle -> the GRACEFUL drain must migrate it to
        # the survivor, where it serves a prefix hit
        lost += load_phase("respike", qps=200.0)
        with router._pool_lock:
            newbie = tuple(router.decode_workers[-1])
        if newbie == seed_addr:
            raise AssertionError("fleet soak: LIFO victim selection "
                                 "would drain the seed worker")
        rs = np.random.RandomState(seed + 1234)
        unique = rs.randint(0, 250, 24).astype(np.int32)
        provider.servers()[newbie].submit(unique, max_new_tokens=2) \
            .get(timeout=600)
        reused_before = seed_srv._kv.prefix_tokens_reused
        if not tick_until(
                lambda: fleet.scale_ins >= 1 and pool_size() == 1,
                timeout=60.0):
            raise AssertionError(
                "fleet soak: the graceful scale-in never converged "
                f"(events: {fleet.events[-8:]})")
        graceful = [e for e in fleet.events
                    if e["action"] == "scale_in"
                    and e.get("outcome") == "drained"]
        if not graceful or not any(e.get("chains", 0) > 0
                                   for e in graceful):
            raise AssertionError(
                "fleet soak: the graceful drain migrated no warm KV "
                f"chains (events: {fleet.events[-8:]})")
        seed_srv.submit(unique, max_new_tokens=2).get(timeout=600)
        reused_after = seed_srv._kv.prefix_tokens_reused
        if reused_after <= reused_before:
            raise AssertionError(
                "fleet soak: the survivor served no prefix hit from the "
                "drained worker's migrated chains "
                f"(reused {reused_before} -> {reused_after})")
        if not any(s == "router.dispatch" for s, _ in plan.fired):
            raise AssertionError(
                "fleet soak armed but the mid-stream router.dispatch "
                "kill never fired — widen the kill window")
        if lost:
            raise AssertionError(
                f"fleet soak lost {lost} request(s): {results}")
        return {
            "seed": seed,
            "requests_per_phase": n_requests,
            "reference": reference,
            "phases": results,
            "events_fired": [f"{s}:{a}" for s, a in plan.fired],
            "scale_outs": fleet.scale_outs,
            "scale_ins": fleet.scale_ins,
            "drains_lost": fleet.drains_lost,
            "chains_migrated": sum(e.get("chains", 0) for e in graceful),
            "failovers": router.failovers,
            "converged_workers": pool_size(),
            "survivor_idle_budget": seed_srv._budget_avail,
            "survivor_tokens_reused": reused_after - reused_before,
            "lost_requests": lost,
            "match": True,
        }
    finally:
        rel.set_plan(None)
        if not was_enabled:
            rel.disable()
        if router is not None:
            router.stop()
        provider.stop_all()
        keys.restore()


# ---------------------------------------------------------------------------
# training, prefix-cache and host-tier drives (tools/chaos_check.py
# --chaos, --kvcache, --kvtier)
# ---------------------------------------------------------------------------

def _train_once(n: int, epochs: int, batch: int, ckpt_dir: Optional[str],
                max_retry: int = 0, device=None) -> float:
    """One deterministic LeNet-5 training run (the examples/lenet_mnist
    model over synthetic digits, unshuffled) → final loss."""
    import bigdl_tpu_torch.nn as nn
    from bigdl_tpu_torch.feature.dataset import LocalDataSet
    from bigdl_tpu_torch.models.lenet import build_model
    from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
    from bigdl_tpu_torch.optim.trigger import Trigger

    nn.set_seed(0)
    rs = np.random.RandomState(0)
    x = rs.rand(n, 1, 28, 28).astype(np.float32)
    y = (rs.randint(0, 10, n) + 1).astype(np.int32)
    opt = LocalOptimizer(build_model(10, device=device),
                         LocalDataSet(x, y, shuffle=False),
                         nn.ClassNLLCriterion(), batch_size=batch,
                         end_trigger=Trigger.max_epoch(epochs),
                         device=device)
    if ckpt_dir:
        opt.set_checkpoint(ckpt_dir, Trigger.every_epoch())
    if max_retry:
        opt.set_max_retry(max_retry)
    opt.optimize()
    return float(opt.state["loss"])


def _with_reliability(fn):
    """Run ``fn()`` with the reliability layer on, disarm the plan after
    and put the master switch back as it was."""
    from bigdl_tpu_torch import reliability as rel
    was_enabled = rel.enabled()
    if not was_enabled:
        rel.enable()
    try:
        return fn()
    finally:
        rel.set_plan(None)
        if not was_enabled:
            rel.disable()


def run_chaos(seed: int = 0, events: int = 5, smoke: bool = True,
              rtol: float = 1e-4, device=None) -> dict:
    """LeNet-5 training under a seeded fault plan: a clean run, then the
    same run with ``events`` raise / corrupt / delay rules drawn over the
    training and checkpoint sites (``FaultPlan.randomize``, the JAX
    drive's draw from the same seed) and a retry budget above them; the
    final losses must match. The unshuffled data, recovery from the last
    epoch's checkpoint with the same batch order, and the quarantine of
    corrupt checkpoints make any divergence a dropped or replayed step.
    On the card cuDNN's backward is not bitwise deterministic, so
    ``rtol`` is the contract there as on the CPU."""
    from bigdl_tpu_torch import reliability as rel

    import tempfile
    n, epochs, batch = (64, 3, 16) if smoke else (256, 5, 32)
    plan = rel.FaultPlan(seed=seed).randomize(
        events, sites=("optimizer.step", "checkpoint.write",
                       "checkpoint.write.manifest",
                       "checkpoint.commit", "optimizer.checkpoint"))

    def drive():
        clean = _train_once(n, epochs, batch, ckpt_dir=None, device=device)
        with tempfile.TemporaryDirectory() as ckpt_dir:
            rel.set_plan(plan)
            injected = _train_once(n, epochs, batch, ckpt_dir=ckpt_dir,
                                   max_retry=events + 1, device=device)
        return clean, injected

    clean, injected = _with_reliability(drive)
    match = bool(np.isclose(clean, injected, rtol=rtol, atol=1e-6))
    out = {
        "seed": seed,
        "events_armed": events,
        "events_fired": [f"{s}:{a}" for s, a in plan.fired],
        "clean_loss": clean,
        "injected_loss": injected,
        "match": match,
    }
    if not match:
        raise AssertionError(
            f"chaos divergence: clean loss {clean} vs injected "
            f"{injected} (fired: {out['events_fired']})")
    return out


def run_kvcache_chaos(model=None, seed: int = 0, n_requests: int = 6,
                      raises: int = 2, device=None) -> dict:
    """Serve a shared-prefix workload through the prefix cache with
    seeded ``kvcache.evict`` faults armed (a delay on every eviction to
    widen race windows, and ``raises`` raises: the site fires before any
    state changes, so the engine loop retries cleanly); greedy outputs
    must equal the clean cache-on run's. The pool (7 pages of 8 tokens)
    is small enough that eviction happens. ``model`` defaults to
    :func:`tiny_model` on ``device``."""
    from bigdl_tpu_torch import reliability as rel
    from bigdl_tpu_torch.llm.serving import LLMServer

    model = model or tiny_model(device)
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 250, 12).astype(np.int32)
    prompts = [np.concatenate([shared,
                               rs.randint(0, 250, 2 + j % 5)
                               .astype(np.int32)])
               for j in range(n_requests)]

    def serve_all():
        srv = LLMServer(model, **_serve_kw(model, num_pages=7,
                                           kvcache=True)).start()
        try:
            reqs = [srv.submit(p, max_new_tokens=4) for p in prompts]
            return ([list(map(int, r.get(timeout=300))) for r in reqs],
                    srv._kv.evictions)
        finally:
            srv.stop()

    plan = rel.FaultPlan(seed=seed)
    # rules match first-wins: the bounded raises go first (skipping
    # the first call), the unbounded delays mop up every other pass
    plan.add("kvcache.evict", "raise", times=raises, after=1)
    plan.add("kvcache.evict", "delay", times=None, delay=0.002)

    def drive():
        clean = serve_all()
        rel.set_plan(plan)
        return clean, serve_all()

    (clean, clean_evicts), (injected, injected_evicts) = \
        _with_reliability(drive)
    match = injected == clean
    out = {
        "seed": seed,
        "requests": n_requests,
        "clean_evictions": clean_evicts,
        "injected_evictions": injected_evicts,
        "events_fired": [f"{s}:{a}" for s, a in plan.fired],
        "match": match,
    }
    if not out["events_fired"]:
        raise AssertionError(
            "kvcache chaos armed but no kvcache.evict fault fired — "
            "the pool was not under pressure; shrink it")
    if not match:
        raise AssertionError(
            f"kvcache chaos divergence under eviction faults "
            f"(fired: {out['events_fired']}): {clean} vs {injected}")
    return out


def run_kvtier_chaos(model=None, seed: int = 0, n_groups: int = 4,
                     fetch_raises: int = 2, spill_raises: int = 1,
                     device=None) -> dict:
    """Drive spill → reload traffic through the host tier with seeded
    ``kvtier.spill`` / ``kvtier.fetch`` faults armed (a delay on every
    migration, raises both ways); greedy outputs must equal the clean
    tier-on run's. Under failure a failed spill is a plain eviction and
    a failed fetch a plain cache miss: never a stall, a crash or another
    token. Requests are served one at a time; the pool (9 pages) holds
    about 2 of the 4 chains, so the second pass reloads from the arena.
    ``model`` defaults to :func:`tiny_model` on ``device``."""
    from bigdl_tpu_torch import reliability as rel
    from bigdl_tpu_torch.llm.serving import LLMServer

    model = model or tiny_model(device)
    rs = np.random.RandomState(seed)
    groups = [rs.randint(0, 250, 16).astype(np.int32)
              for _ in range(n_groups)]
    prompts = []
    for rnd in range(2):          # two passes: seed chains, then reload
        for g in range(n_groups):
            prompts.append(np.concatenate(
                [groups[g], rs.randint(0, 250, 2 + (rnd + g) % 3)
                 .astype(np.int32)]))

    def serve_all():
        srv = LLMServer(model, **_serve_kw(
            model, num_pages=9, kvcache=True, kvtier=True,
            host_pages=32)).start()
        try:
            got = [list(map(int,
                            srv.submit(p, max_new_tokens=4)
                            .get(timeout=300)))
                   for p in prompts]
            srv._tier.migrator.drain()
            return got, srv._tier.spills, srv._tier.fetches
        finally:
            srv.stop()

    plan = rel.FaultPlan(seed=seed)
    # first-match-wins: bounded raises first, unbounded delays mop up
    # every other migration
    plan.add("kvtier.fetch", "raise", times=fetch_raises, after=0)
    plan.add("kvtier.spill", "raise", times=spill_raises, after=1)
    plan.add("kvtier.*", "delay", times=None, delay=0.003)

    def drive():
        clean = serve_all()
        rel.set_plan(plan)
        return clean, serve_all()

    (clean, clean_spills, clean_fetches), \
        (injected, inj_spills, inj_fetches) = _with_reliability(drive)
    match = injected == clean
    out = {
        "seed": seed,
        "requests": len(prompts),
        "clean_spills": clean_spills,
        "clean_fetches": clean_fetches,
        "injected_spills": inj_spills,
        "injected_fetches": inj_fetches,
        "events_fired": [f"{s}:{a}" for s, a in plan.fired],
        "match": match,
    }
    if clean_fetches == 0:
        raise AssertionError(
            "kvtier chaos: the clean run never fetched from the host "
            "arena — the pool is not under pressure; shrink it")
    if not any(s.startswith("kvtier.") for s, _ in plan.fired):
        raise AssertionError(
            "kvtier chaos armed but no kvtier fault fired")
    if not match:
        raise AssertionError(
            f"kvtier chaos divergence under migration faults "
            f"(fired: {out['events_fired']}): {clean} vs {injected}")
    return out


DRIVES = {"failover": run_failover_chaos, "alerts": run_alerts_chaos,
          "fleet": run_fleet_chaos, "chaos": run_chaos,
          "kvcache": run_kvcache_chaos, "kvtier": run_kvtier_chaos}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.llm.chaos",
        description="Run a chaos drive of the serving stack; print its "
                    "report as JSON; exit 1 when its contract breaks.")
    mode = ap.add_mutually_exclusive_group(required=True)
    for name in DRIVES:
        mode.add_argument(f"--{name}", dest="drive", action="store_const",
                          const=name)
    ap.add_argument("--smoke", action="store_true",
                    help="the shrunken storm (fewer requests)")
    ap.add_argument("--full", action="store_true",
                    help="--chaos: the bigger training run (default: its "
                         "smoke run)")
    ap.add_argument("--events", type=int, default=5,
                    help="--chaos: the fault rules drawn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    kw = dict(seed=args.seed, device=args.device)
    if args.drive == "chaos":
        kw.update(smoke=not args.full, events=args.events)
    elif args.drive in ("failover", "alerts", "fleet"):
        kw.update(smoke=args.smoke)
    try:
        out = DRIVES[args.drive](**kw)
    except AssertionError as e:
        print(json.dumps({"drive": args.drive, "ok": False,
                          "error": str(e)}))
        return 1
    out.pop("outputs", None)
    print(json.dumps({"drive": args.drive, "ok": True, **out},
                     default=str))
    return 0


__all__ = ["DRIVES", "main", "run_alerts_chaos", "run_chaos",
           "run_failover_chaos", "run_fleet_chaos", "run_kvcache_chaos",
           "run_kvtier_chaos", "tiny_model"]


if __name__ == "__main__":
    sys.exit(main())
