"""The router's failover chaos drive — the port of the JAX package's
``tools/chaos_check.py`` ``run_failover_chaos``.

Two decode workers behind a failover-enabled :class:`~bigdl_tpu_torch.
llm.worker.LLMRouter`; seeded ``router.dispatch`` raises tear the
router → worker stream after tokens drained, and a seeded
``worker.stall`` wedges one engine past its watchdog. Every request
must still complete with greedy output equal to ``model.generate``,
the journal resuming ``prompt + generated_so_far`` on the surviving
backend, and the router's SLO sketches must count each token once. The
disabled router is checked first: no journal, no prober, no collector
thread, no failover / hedge / SLO series.

    from bigdl_tpu_torch.llm.chaos import run_failover_chaos
    run_failover_chaos(device="cpu", smoke=True)

The CPU holds the resumed output bit for bit to ``generate`` (f32
weights and cache by default). On the card a resumed suffix is
prefilled where the first backend decoded it, so bf16 sums may part:
there hold it to the surviving engine's own answer, as ``chip_smoke.py``
phase 12 does.
"""

from __future__ import annotations

import http.client
import json
import threading
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
    kw = dict(max_batch=2, max_seq_len=64, page_size=8, device=model.device)

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


__all__ = ["run_failover_chaos", "tiny_model"]
