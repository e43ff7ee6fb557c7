"""Closed-loop load generator for the serving stack — the port of the
JAX package's ``tools/loadgen.py``.

Drives mixed prompt/output-length traffic at a controlled arrival rate
through the router → prefill → decode path (``POST /worker_generate``
on any router or worker address; the streamed and OpenAI routes with
``stream`` / ``openai``) and reports what a client actually saw:
per-request completion-latency percentiles (its own per-run
:class:`~bigdl_tpu_torch.observability.sketch.QuantileSketch`,
independent of the process-global registry), 503-shed retries, and the
number a fleet soak is judged on — **requests lost** (a request is lost
only when it exhausts its retries or fails non-retriably; a shed that
later succeeds is latency, not loss).

The generator is closed-loop with scheduled arrivals: request *i* is
due at ``t0 + i/qps``; a bounded pool of client threads picks up due
requests (falling behind under overload instead of stacking unbounded
connections — the closed-loop part), and each 503 (or the gateway's
429) backs off by the server's own ``Retry-After`` (capped) before
retrying.

Outputs are collected **per prompt index**, so callers can assert
greedy bit-parity against a clean run — ``llm.chaos.run_fleet_chaos``
does exactly that while killing workers mid-drain.

Router-scope TTFT/ITL under soak (``bigdl_router_ttft_seconds`` /
``bigdl_llm_itl_seconds`` sketches, ``slo=True``) are cumulative in the
process registry; :func:`sketch_window` subtracts a before-snapshot
from an after-snapshot bucket-wise (sketch buckets are plain counts, so
the difference is itself a valid sketch of exactly the in-between
samples): the per-soak p99s of :func:`run_fleet_soak`.

Usage (against a running router or worker)::

    python -m bigdl_tpu_torch.tools.loadgen --url 127.0.0.1:8000 \\
        --requests 64 --qps 20 [--max-new 8] [--seed 0] [--openai]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: mixed prompt-length ladder (tokens) the seeded generator cycles
#: through — short chat turns to page-spanning contexts
PROMPT_LENS = (6, 10, 16, 24, 40)
#: mixed output budgets paired with them
OUTPUT_LENS = (2, 4, 6, 8)

#: SLO-class request header + known classes — kept literal here so the
#: CLI works without importing the serving stack
PRIORITY_HEADER = "X-BigDL-Priority"
PRIORITY_CLASSES = ("interactive", "standard", "batch")

#: model id the OpenAI gateway serves — the worker/router default;
#: --openai-model overrides for renamed deployments
OPENAI_MODEL = "bigdl-tpu-llm"


def parse_priority_mix(spec: str) -> List[Tuple[str, int]]:
    """``"interactive:1,standard:1,batch:2"`` → ``[(class, weight)]``.
    Weights are relative request counts in the deterministic
    round-robin pattern :func:`assign_classes` cycles through."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        weight = int(w) if w else 1
        if weight < 0:
            raise ValueError(f"negative weight in --priority-mix: {part}")
        cls = name.strip().lower()
        if cls not in PRIORITY_CLASSES:
            # the server degrades unknown classes to "standard", but a
            # typo'd mix spec should fail fast, not skew the soak
            raise ValueError(f"unknown class in --priority-mix: {part} "
                             f"(known: {', '.join(PRIORITY_CLASSES)})")
        out.append((cls, weight))
    if not out or all(w == 0 for _, w in out):
        raise ValueError(f"empty --priority-mix spec: {spec!r}")
    return out


def assign_classes(n: int, mix: List[Tuple[str, int]]) -> List[str]:
    """Deterministic per-request class list: the weighted pattern
    (each class repeated ``weight`` times) cycled over ``n`` requests,
    so reruns of a seeded soak see identical class placement."""
    pattern = [cls for cls, w in mix for _ in range(w)]
    return [pattern[i % len(pattern)] for i in range(n)]


def gen_prompts(n: int, seed: int = 0, vocab: int = 250,
                shared_prefix: int = 0) -> List[Any]:
    """``n`` seeded int32 prompts over the length ladder; an optional
    shared prefix makes the workload prefix-cache-friendly (the drain
    migration's warm chains come from exactly such sharing)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    prefix = rs.randint(0, vocab, shared_prefix).astype(np.int32) \
        if shared_prefix else None
    out = []
    for j in range(n):
        body = rs.randint(0, vocab,
                          PROMPT_LENS[j % len(PROMPT_LENS)]) \
            .astype(np.int32)
        out.append(body if prefix is None
                   else np.concatenate([prefix, body]))
    return out


def _post(addr: Tuple[str, int], body: dict, timeout: float,
          headers: Optional[dict] = None):
    import http.client
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    try:
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        conn.request("POST", "/worker_generate", json.dumps(body), hdrs)
        resp = conn.getresponse()
        data = resp.read()
        try:
            parsed = json.loads(data.decode())
        except ValueError:
            parsed = {"error": data.decode(errors="replace")[:200]}
        return resp.status, parsed, resp.msg
    finally:
        conn.close()


def _post_stream(addr: Tuple[str, int], body: dict, timeout: float,
                 headers: Optional[dict] = None):
    """``/worker_generate_stream`` client leg: returns ``(status,
    final_payload, msg, ttft_s, itl_gaps_s)``. TTFT is request-send to
    the first token-bearing chunk; ITL gaps are wall time between
    consecutive token-bearing chunks (a chunk may batch tokens, so this
    is the client-visible gap, the same thing a streaming UI stalls
    on)."""
    import http.client
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    try:
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        t_send = time.perf_counter()
        conn.request("POST", "/worker_generate_stream",
                     json.dumps(body), hdrs)
        resp = conn.getresponse()
        if resp.status != 200:
            data = resp.read()
            try:
                parsed = json.loads(data.decode())
            except ValueError:
                parsed = {"error": data.decode(errors="replace")[:200]}
            return resp.status, parsed, resp.msg, None, []
        ttft = None
        gaps: List[float] = []
        t_prev = None
        seen = 0
        last: dict = {}
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line.decode())
            except ValueError:
                continue
            now = time.perf_counter()
            ntok = len(obj.get("output_ids", []))
            if ntok > seen:
                if ttft is None:
                    ttft = now - t_send
                elif t_prev is not None:
                    gaps.append(now - t_prev)
                t_prev = now
                seen = ntok
            last = obj
            if obj.get("done"):
                break
        return 200, last, resp.msg, ttft, gaps
    finally:
        conn.close()


def _openai_error(parsed: dict) -> dict:
    """Normalize an OpenAI error body to the native ``{"error": msg}``
    shape the retry/report loop already understands."""
    err = parsed.get("error")
    if isinstance(err, dict):
        return {"error": err.get("message", "")}
    return parsed


def _post_openai(addr: Tuple[str, int], body: dict, timeout: float,
                 headers: Optional[dict] = None,
                 model: str = OPENAI_MODEL):
    """Blocking ``/v1/completions`` leg: same return shape
    as :func:`_post` — the choice's ``token_ids`` renamed to
    ``output_ids`` so parity asserts are endpoint-agnostic."""
    import http.client
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    try:
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        req = {"model": model,
               "prompt": body["prompt_ids"],
               "max_tokens": body["max_new_tokens"]}
        conn.request("POST", "/v1/completions", json.dumps(req), hdrs)
        resp = conn.getresponse()
        data = resp.read()
        try:
            parsed = json.loads(data.decode())
        except ValueError:
            parsed = {"error": data.decode(errors="replace")[:200]}
        if resp.status != 200:
            return resp.status, _openai_error(parsed), resp.msg
        choice = parsed["choices"][0]
        return 200, {"output_ids": choice.get("token_ids", []),
                     "finish_reason": choice.get("finish_reason")}, \
            resp.msg
    finally:
        conn.close()


def _post_stream_openai(addr: Tuple[str, int], body: dict,
                        timeout: float,
                        headers: Optional[dict] = None,
                        model: str = OPENAI_MODEL):
    """SSE ``/v1/completions`` leg: same return shape as
    :func:`_post_stream`. TTFT/ITL are measured at the SSE boundary —
    the client-visible numbers the gateway's journal stamps must
    reconcile with. A mid-stream SSE ``error`` event surfaces as a
    retriable ``{"error": ...}`` final payload, mirroring the native
    stream's terminal error chunk."""
    import http.client

    from bigdl_tpu_torch.llm.api.sse import parse_sse
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    try:
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        req = {"model": model,
               "prompt": body["prompt_ids"],
               "max_tokens": body["max_new_tokens"],
               "stream": True}
        t_send = time.perf_counter()
        conn.request("POST", "/v1/completions", json.dumps(req), hdrs)
        resp = conn.getresponse()
        if resp.status != 200:
            data = resp.read()
            try:
                parsed = json.loads(data.decode())
            except ValueError:
                parsed = {"error": data.decode(errors="replace")[:200]}
            return resp.status, _openai_error(parsed), resp.msg, None, []
        ttft = None
        gaps: List[float] = []
        t_prev = None
        tokens: List[int] = []
        finish = None
        err = None
        for obj in parse_sse(resp):
            now = time.perf_counter()
            if "error" in obj:
                err = _openai_error(obj)["error"]
                continue
            choice = (obj.get("choices") or [{}])[0]
            new = choice.get("token_ids", [])
            if new:
                if ttft is None:
                    ttft = now - t_send
                elif t_prev is not None:
                    gaps.append(now - t_prev)
                t_prev = now
                tokens.extend(int(t) for t in new)
            if choice.get("finish_reason"):
                finish = choice["finish_reason"]
        if err is not None:
            return 200, {"error": err}, resp.msg, ttft, gaps
        return 200, {"output_ids": tokens, "finish_reason": finish}, \
            resp.msg, ttft, gaps
    finally:
        conn.close()


def run_load(addr: Tuple[str, int], prompts: Sequence[Any],
             max_new_tokens: Any = 4, qps: float = 20.0,
             concurrency: int = 4,
             max_retries: int = 20, retry_cap_s: float = 0.25,
             request_timeout: float = 120.0,
             priorities: Optional[Sequence[str]] = None,
             stream: bool = False,
             openai: bool = False,
             openai_model: str = OPENAI_MODEL,
             while_outstanding: Optional[Callable[[], None]] = None
             ) -> Dict[str, Any]:
    """Drive ``prompts`` through ``addr`` at ``qps`` scheduled arrivals.
    ``max_new_tokens`` may be one int or a per-prompt sequence of the
    same length (the mixed-output part of the soak). ``priorities``
    (per-prompt SLO-class names) are sent as the
    ``X-BigDL-Priority`` header and split every counter/sketch per
    class under the ``per_class`` result key. ``stream=True`` uses the
    streaming endpoint so the per-class sketches include client-visible
    TTFT and ITL, not just completion latency. Returns the result
    record described in the module docstring; ``outputs[i]`` is request
    ``i``'s token list (None when lost — the zero-lost assertion is
    ``lost == 0``). ``openai=True`` drives the same traffic
    through the gateway's ``/v1/completions`` instead — SSE when
    ``stream`` — retrying the gateway's 429 translation of a shed
    exactly like the native 503 (same Retry-After honor), so every
    parity/loss assertion is endpoint-agnostic. ``while_outstanding``,
    when given, is called again and again (1 ms apart) from the calling
    thread while any request is sent and not yet answered: a fleet
    controller ticked there samples the queue for as long as the load
    holds it, however fast the load drains."""
    from bigdl_tpu_torch.observability.sketch import QuantileSketch
    n = len(prompts)
    if isinstance(max_new_tokens, (list, tuple)):
        if len(max_new_tokens) != n:
            raise ValueError(
                f"max_new_tokens has {len(max_new_tokens)} entries "
                f"for {n} prompts")
        budgets = [int(v) for v in max_new_tokens]
    else:
        budgets = [int(max_new_tokens)] * n
    if priorities is not None and len(priorities) != n:
        raise ValueError(
            f"priorities has {len(priorities)} entries for {n} prompts")
    outputs: List[Optional[List[int]]] = [None] * n
    errors: List[dict] = []
    sketch = QuantileSketch()
    lock = threading.Lock()
    counters = {"ok": 0, "lost": 0, "retries_503": 0, "outstanding": 0}
    per_class: Dict[str, Dict[str, Any]] = {}
    if priorities is not None:
        for cls in priorities:
            per_class.setdefault(cls, {
                "sent": 0, "ok": 0, "lost": 0, "retries_503": 0,
                "latency": QuantileSketch(), "ttft": QuantileSketch(),
                "itl": QuantileSketch()})
            per_class[cls]["sent"] += 1
    next_idx = [0]
    t0 = time.perf_counter()

    def take() -> Optional[int]:
        with lock:
            if next_idx[0] >= n:
                return None
            i = next_idx[0]
            next_idx[0] += 1
        due = t0 + i / max(qps, 1e-9)
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        return i

    def client():
        while True:
            i = take()
            if i is None:
                return
            body = {"prompt_ids": [int(t) for t in prompts[i]],
                    "max_new_tokens": budgets[i]}
            cls = priorities[i] if priorities is not None else None
            req_headers = {PRIORITY_HEADER: cls} if cls else None
            t_req = time.perf_counter()
            with lock:
                counters["outstanding"] += 1
            try:
                done, last_err = attempt(i, body, cls, req_headers, t_req)
            finally:
                with lock:
                    counters["outstanding"] -= 1
            if not done:
                with lock:
                    counters["lost"] += 1
                    if cls is not None:
                        per_class[cls]["lost"] += 1
                    errors.append({"request": i, "error": last_err})

    def attempt(i, body, cls, req_headers, t_req):
        """Request ``i`` with its retries: ``(done, last error)``."""
        last_err = "retries exhausted"
        done = False
        for _attempt in range(max_retries + 1):
            ttft = None
            gaps: List[float] = []
            try:
                if stream and openai:
                    status, parsed, hdrs, ttft, gaps = \
                        _post_stream_openai(addr, body,
                                            request_timeout,
                                            req_headers,
                                            model=openai_model)
                elif stream:
                    status, parsed, hdrs, ttft, gaps = \
                        _post_stream(addr, body, request_timeout,
                                     req_headers)
                elif openai:
                    status, parsed, hdrs = _post_openai(
                        addr, body, request_timeout, req_headers,
                        model=openai_model)
                else:
                    status, parsed, hdrs = _post(
                        addr, body, request_timeout, req_headers)
            except Exception as e:  # noqa: BLE001 — retriable
                last_err = f"transport: {e}"
                time.sleep(min(0.05, retry_cap_s))
                continue
            if status == 200 and parsed.get("error") is not None:
                # terminal stream chunk carried the engine's error
                # (retriable) — same treatment as a transport fault
                last_err = f"stream: {parsed['error']}"
                time.sleep(min(0.05, retry_cap_s))
                continue
            if status == 200:
                lat = time.perf_counter() - t_req
                with lock:
                    outputs[i] = [int(t)
                                  for t in parsed["output_ids"]]
                    counters["ok"] += 1
                    sketch.observe(lat)
                    if cls is not None:
                        rec = per_class[cls]
                        rec["ok"] += 1
                        rec["latency"].observe(lat)
                        if ttft is not None:
                            rec["ttft"].observe(ttft)
                        for g in gaps:
                            rec["itl"].observe(g)
                done = True
                break
            if status in (503, 429):
                # backpressure: honor the server's Retry-After
                # (capped — the soak must finish), then retry. 429
                # is the gateway's OpenAI translation of the same
                # shed. Shed-then-served is latency, never loss.
                with lock:
                    counters["retries_503"] += 1
                    if cls is not None:
                        per_class[cls]["retries_503"] += 1
                try:
                    ra = float(hdrs.get("Retry-After") or 0.05)
                except (TypeError, ValueError):
                    ra = 0.05
                time.sleep(min(max(ra, 0.01), retry_cap_s))
                last_err = f"503: {parsed.get('error', '')}"
                continue
            last_err = f"{status}: {parsed.get('error', '')}"
            break
        return done, last_err

    threads = [threading.Thread(target=client,
                                name=f"bigdl-loadgen-{k}", daemon=True)
               for k in range(max(1, concurrency))]
    for t in threads:
        t.start()
    if while_outstanding is not None:
        while any(t.is_alive() for t in threads):
            if counters["outstanding"]:
                while_outstanding()
            time.sleep(0.001)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    qs = sketch.quantiles((0.5, 0.95, 0.99))
    out = {
        "sent": n,
        "ok": counters["ok"],
        "lost": counters["lost"],
        "retries_503": counters["retries_503"],
        "wall_s": round(wall, 3),
        "achieved_qps": round(counters["ok"] / max(wall, 1e-9), 2),
        "latency_p50_ms": _ms(qs.get(0.5)),
        "latency_p95_ms": _ms(qs.get(0.95)),
        "latency_p99_ms": _ms(qs.get(0.99)),
        "outputs": outputs,
        "errors": errors[:16],
    }
    if priorities is not None:
        out["per_class"] = {
            cls: _class_report(rec) for cls, rec in per_class.items()}
    return out


def _class_report(rec: Dict[str, Any]) -> Dict[str, Any]:
    lat = rec["latency"].quantiles((0.5, 0.99))
    ttft = rec["ttft"].quantiles((0.5, 0.99))
    itl = rec["itl"].quantiles((0.99,))
    return {
        "sent": rec["sent"], "ok": rec["ok"], "lost": rec["lost"],
        "retries_503": rec["retries_503"],
        "latency_p50_ms": _ms(lat.get(0.5)),
        "latency_p99_ms": _ms(lat.get(0.99)),
        "ttft_p50_ms": _ms(ttft.get(0.5)),
        "ttft_p99_ms": _ms(ttft.get(0.99)),
        "itl_p99_ms": _ms(itl.get(0.99)),
    }


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1000.0, 3)


# ---------------------------------------------------------------------------
# registry-sketch windows (per-soak TTFT/ITL out of a shared registry)
# ---------------------------------------------------------------------------

def registry_sketch_snapshot(name: str) -> Optional[dict]:
    """The unlabeled series' sketch snapshot for metric ``name`` from
    the process registry (None when absent — e.g. SLO off)."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.observability.metrics import _SketchChild
    for m in obs.REGISTRY.collect():
        if m.name != name:
            continue
        for _key, child in m.children():
            if isinstance(child, _SketchChild):
                return child.to_snapshot()
    return None


def sketch_window(before: Optional[dict], after: Optional[dict],
                  qs=(0.5, 0.95, 0.99)) -> Dict[float, Optional[float]]:
    """Quantiles of the samples observed BETWEEN two snapshots of one
    cumulative sketch (the time-series plane's
    :func:`~bigdl_tpu_torch.observability.timeseries.sketch_window`)."""
    from bigdl_tpu_torch.observability.timeseries import (
        sketch_window as _sketch_window)
    return _sketch_window(before, after, qs)


def _default_model(model, device):
    """``model``, or the chaos drives' tiny f32 Llama on ``device``
    (``None`` = the GPU)."""
    if model is not None:
        return model
    from bigdl_tpu_torch.llm.chaos import tiny_model
    return tiny_model(device)


#: the soak's own controller cadence (the load generator ticks it as well
#: while the spike is outstanding)
SOAK_TICK_S = 0.02


def run_fleet_soak(n_requests: int = 8, qps: float = 100.0,
                   seed: int = 0,
                   priority_mix: Optional[str] = None,
                   openai: bool = False, model=None,
                   device=None) -> Dict[str, Any]:
    """A fault-free soak of the elastic fleet: a spike against one
    worker, autoscaler scale-out, graceful drain-and-scale-in back to
    the floor — reporting client-visible p99 TTFT / engine p99 ITL for
    exactly this soak's requests (SLO sketch windows), requests lost
    (must be 0), and the scale-event counts. ``priority_mix`` (a
    :func:`parse_priority_mix` spec) turns on the SLO-class scheduler in
    the pool's workers, stamps each request with its class, and adds a
    ``per_class`` block. ``openai=True`` enables the gateway on every
    pool worker and the router and drives the same soak through
    ``/v1/completions`` SSE instead of the native endpoint. ``model``
    (the pool's shared weights, served at its own page size) defaults to
    a tiny f32 Llama on ``device``. The controller is ticked by the
    load generator while any request of the spike is outstanding
    (``run_load``'s ``while_outstanding``), so a spike that drains
    fast is still sampled while it queues, and every ``SOAK_TICK_S``
    seconds by this loop until the pool has drained back to one
    worker. The chaos variant with kills is
    :func:`bigdl_tpu_torch.llm.chaos.run_fleet_chaos`."""
    from bigdl_tpu_torch.llm.fleet import LocalWorkerProvider
    from bigdl_tpu_torch.llm.worker import LLMRouter
    from bigdl_tpu_torch.utils.conf import conf

    model = _default_model(model, device)
    prompts = gen_prompts(n_requests, seed=seed, shared_prefix=16)
    classes = (assign_classes(n_requests, parse_priority_mix(
        priority_mix)) if priority_mix else None)
    with conf._lock:
        prev_sync = conf._set_layer.get("bigdl.llm.kvtier.sync")
    conf.set("bigdl.llm.kvtier.sync", "true")
    server_kwargs = dict(
        max_batch=2, max_seq_len=64, num_pages=24,
        kvcache=True, kvtier=True, host_pages=64, max_queue=8,
        slo=True, device=model.device)
    if classes is not None:
        server_kwargs["priority"] = True
    worker_kwargs = dict(api=True) if openai else None
    provider = LocalWorkerProvider(model, server_kwargs=server_kwargs,
                                   worker_kwargs=worker_kwargs)
    router = None
    ttft_before = registry_sketch_snapshot("bigdl_router_ttft_seconds")
    itl_before = registry_sketch_snapshot("bigdl_llm_itl_seconds")
    try:
        seed_addr = provider.launch()
        srv = provider.servers()[seed_addr]
        for p in prompts:       # warm every served shape first
            srv.submit(p, max_new_tokens=1).get(timeout=600)
            srv.submit(p, max_new_tokens=1).get(timeout=600)
        router = LLMRouter(
            [], [seed_addr], failover=True, failover_attempts=8,
            start_prober=False, slo=True, fleet=True,
            provider=provider, start_fleet=False, api=openai,
            fleet_opts=dict(min_workers=1, max_workers=3,
                            interval=0.05, cooldown=0.0, sustain=1,
                            queue_high=1.0, idle_low=0.0,
                            drain_timeout=20.0)).start()
        fleet = router._fleet
        holder: Dict[str, Any] = {}
        tick_lock = threading.Lock()

        def _tick():
            with tick_lock:
                fleet.tick()

        def _run():
            holder["res"] = run_load(router.address, prompts,
                                     max_new_tokens=4, qps=qps,
                                     concurrency=4,
                                     priorities=classes,
                                     openai=openai, stream=openai,
                                     while_outstanding=_tick)
        t = threading.Thread(target=_run, daemon=True)
        t.start()
        deadline = time.time() + 60.0
        while time.time() < deadline:
            _tick()
            if not t.is_alive() and fleet.scale_ins >= 1 and \
                    len(router.decode_workers) == 1:
                break
            time.sleep(SOAK_TICK_S)
        t.join(timeout=600)
        res = holder.get("res") or {}
        ttft = sketch_window(
            ttft_before,
            registry_sketch_snapshot("bigdl_router_ttft_seconds"))
        itl = sketch_window(
            itl_before,
            registry_sketch_snapshot("bigdl_llm_itl_seconds"))
        out = {
            "requests": n_requests,
            "qps_target": qps,
            "requests_lost": int(res.get("lost", 0)),
            "retries_503": int(res.get("retries_503", 0)),
            "scale_outs": fleet.scale_outs,
            "scale_ins": fleet.scale_ins,
            "converged_workers": len(router.decode_workers),
            "latency_p99_ms": res.get("latency_p99_ms"),
            "ttft_p50_ms": _ms(ttft.get(0.5)),
            "ttft_p99_ms": _ms(ttft.get(0.99)),
            "itl_p99_ms": _ms(itl.get(0.99)),
        }
        if "per_class" in res:
            out["per_class"] = res["per_class"]
        return out
    finally:
        if router is not None:
            router.stop()
        provider.stop_all()
        if prev_sync is None:
            conf.unset("bigdl.llm.kvtier.sync")
        else:
            conf.set("bigdl.llm.kvtier.sync", prev_sync)


def run_openai_bench(n_requests: int = 6, max_new: int = 6,
                     seed: int = 0, model=None,
                     device=None) -> Dict[str, Any]:
    """One api-enabled worker, the same seeded prompts streamed twice —
    native ``/worker_generate_stream`` vs gateway ``/v1/completions``
    SSE — reporting client-visible TTFT p50 for both and the gateway's
    added latency (translation + SSE framing over the same engine path).
    Outputs must be identical between the two endpoints; mismatches are
    reported, not asserted. ``model`` defaults to a tiny f32 Llama on
    ``device``."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMWorker
    from bigdl_tpu_torch.observability.sketch import QuantileSketch

    model = _default_model(model, device)
    prompts = gen_prompts(n_requests, seed=seed)
    srv = LLMServer(model, max_batch=2, max_seq_len=64, kvcache=True,
                    device=model.device).start()
    worker = LLMWorker(srv, api=True).start()
    try:
        for p in prompts:       # warm every served shape first
            srv.submit(p, max_new_tokens=1).get(timeout=600)
        addr = worker.address
        direct = QuantileSketch()
        gateway = QuantileSketch()
        mismatches = 0
        for p in prompts:
            body = {"prompt_ids": [int(t) for t in p],
                    "max_new_tokens": max_new}
            st, native, _, t_direct, _ = _post_stream(addr, body, 120.0)
            st2, via, _, t_gw, _ = _post_stream_openai(addr, body, 120.0)
            if st == 200 and t_direct is not None:
                direct.observe(t_direct)
            if st2 == 200 and t_gw is not None:
                gateway.observe(t_gw)
            if st != 200 or st2 != 200 or \
                    list(native.get("output_ids", [])) != \
                    list(via.get("output_ids", [])):
                mismatches += 1
        d50 = direct.quantiles((0.5,)).get(0.5)
        g50 = gateway.quantiles((0.5,)).get(0.5)
        return {
            "requests": n_requests,
            "ttft_direct_p50_ms": _ms(d50),
            "ttft_gateway_p50_ms": _ms(g50),
            "gateway_overhead_ms": (
                None if d50 is None or g50 is None
                else round((g50 - d50) * 1000.0, 3)),
            "output_mismatches": mismatches,
        }
    finally:
        worker.stop()
        srv.stop()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.tools.loadgen",
        description="Closed-loop load against a router or worker.")
    ap.add_argument("--url", required=True,
                    help="router or worker address, host:port")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--qps", type=float, default=20.0)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of seeded shared prefix across all "
                         "prompts (exercises the prefix cache)")
    ap.add_argument("--priority-mix", default=None,
                    help="mixed-class soak: weighted SLO classes, e.g. "
                         "'interactive:1,standard:1,batch:2' — stamps "
                         "X-BigDL-Priority and reports per-class "
                         "TTFT/ITL sketches")
    ap.add_argument("--no-stream", action="store_true",
                    help="with --priority-mix or --openai, use the "
                         "blocking endpoint (per-class TTFT/ITL "
                         "unavailable; needed when a priority-mix "
                         "target is a router)")
    ap.add_argument("--openai", action="store_true",
                    help="drive the OpenAI gateway (/v1/completions, "
                         "SSE unless --no-stream) instead of the "
                         "native endpoints; requires "
                         "bigdl.llm.api.enabled on the target")
    ap.add_argument("--openai-model", default=OPENAI_MODEL,
                    help="model id to send with --openai (must match "
                         "the target's served model)")
    args = ap.parse_args(argv)
    host, port = args.url.replace("http://", "").rsplit(":", 1)
    prompts = gen_prompts(args.requests, seed=args.seed,
                          shared_prefix=args.shared_prefix)
    classes = (assign_classes(args.requests, parse_priority_mix(
        args.priority_mix)) if args.priority_mix else None)
    out = run_load((host, int(port)), prompts,
                   max_new_tokens=args.max_new, qps=args.qps,
                   concurrency=args.concurrency,
                   priorities=classes,
                   openai=args.openai,
                   openai_model=args.openai_model,
                   stream=bool((classes is not None or args.openai)
                               and not args.no_stream))
    out.pop("outputs")          # token lists are for parity asserts,
    print(json.dumps(out, indent=1))   # not for the CLI report
    return 1 if out["lost"] else 0


if __name__ == "__main__":
    sys.exit(main())
