"""The port's HTTP worker and OpenAI gateway (``bigdl_tpu_torch/llm/
worker.py``, ``llm/api``) against the JAX package's: a JAX ``LLMWorker``
over the JAX engine and the port's over the port's engine, on the same
tiny f32 q4_0 weights, answer the same requests with the same bodies
and status codes — ``/worker_generate`` and the joined stream, the 422 /
503 + Retry-After / 403 splits, ``/healthz`` and its 503 "stalled",
the prefill worker's handoff blob (its wire byte for byte, its K/V to
f32 rounding; imported by a decode worker of either package),
``/v1/completions`` and
``/v1/chat/completions`` plain and SSE, the OpenAI error bodies,
``/v1/models`` and the 404s of the endpoints the port has not ported.
A JAX ``LLMRouter`` serves through a port worker with the same ids."""

import base64
import http.client
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm import worker as jworker
from bigdl_tpu.llm.api.sse import parse_sse
from bigdl_tpu.llm.kvtier import handoff as jhandoff
from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.llm.serving import LLMServer as JServer

from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch.llm.api import ByteTokenizer
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer
from bigdl_tpu_torch.llm.worker import LLMWorker

PAGE = 8
KW = dict(max_batch=2, max_seq_len=64, page_size=PAGE)
TIER = dict(KW, kvcache=True, kvtier=True, host_pages=32)


@pytest.fixture(scope="module")
def fleet():
    """Per package: a started engine behind an api worker, and a prefill
    and a decode worker over host-tier engines."""
    cfg = jllama.LlamaConfig.tiny()
    p = jllama.quantize_params(jllama.init_params(cfg, 0, dtype=jnp.float32),
                               "sym_int4")
    jm = jllama.LlamaForCausalLM(cfg, p, max_cache_len=128,
                                 cache_dtype=jnp.float32)
    tm = tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
        cache_dtype=torch.float32, page_size=PAGE, device="cpu")
    out, stop = {}, []
    for side, mk, wk in (
            ("jax", lambda **k: JServer(jm, ragged_prefill=True, **k),
             jworker.LLMWorker),
            ("torch", lambda **k: LLMServer(tm, device="cpu", **k),
             LLMWorker)):
        srv = mk(**KW).start()
        pre, dec = mk(**TIER).start(), mk(**TIER).start()
        workers = {"api": wk(srv, api=True, tokenizer=ByteTokenizer()),
                   "prefill": wk(pre, role="prefill"),
                   "decode": wk(dec, role="decode"), "plain": wk(srv)}
        for w in workers.values():
            w.start()
        out[side] = workers
        stop += list(workers.values()) + [srv, pre, dec]
    out["model"] = jm
    yield out
    for x in stop:
        x.stop()


def _req(addr, method, path, body=None, raw=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        payload = raw if raw is not None else (
            json.dumps(body) if body is not None else None)
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


def _lines(addr, body):
    """The native stream's JSON lines."""
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.request("POST", "/worker_generate_stream", json.dumps(body))
        r = conn.getresponse()
        return [json.loads(x) for x in r.read().decode().splitlines() if x]
    finally:
        conn.close()


def _sse(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.request("POST", path, json.dumps(dict(body, stream=True)))
        return list(parse_sse(conn.getresponse()))
    finally:
        conn.close()


def _both(fleet, which, fn):
    return [fn(fleet[side][which].address) for side in ("jax", "torch")]


def _golden(jm, ids, n):
    return [int(t) for t in jm.generate(np.asarray(ids, np.int32)[None],
                                        max_new_tokens=n)[0, len(ids):]]


PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2], [27, 18]]


@pytest.mark.parametrize("k", range(len(PROMPTS)))
def test_generate_and_stream(fleet, k):
    body = {"prompt_ids": PROMPTS[k], "max_new_tokens": 6 + k}
    want, got = _both(fleet, "api", lambda a: _req(
        a, "POST", "/worker_generate", body)[:2])
    assert got == want
    assert got[1]["output_ids"] == _golden(fleet["model"], PROMPTS[k], 6 + k)
    streams = _both(fleet, "api", lambda a: _lines(a, body))
    assert streams[1][-1]["output_ids"] == got[1]["output_ids"]
    assert [c["done"] for c in streams[1]][-1] and \
        streams[1][-1]["finish_reason"] == "length"
    assert streams[0][-1] == streams[1][-1]


@pytest.mark.parametrize("case", ["infeasible", "bad_json", "prefill_role",
                                  "decode_role", "import_on_prefill"])
def test_error_statuses(fleet, case):
    which, path, body, raw = {
        "infeasible": ("api", "/worker_generate",
                       {"prompt_ids": [1] * 60, "max_new_tokens": 10}, None),
        "bad_json": ("api", "/worker_generate", None, b"{nope"),
        "prefill_role": ("prefill", "/worker_generate",
                         {"prompt_ids": [1, 2]}, None),
        "decode_role": ("decode", "/worker_prefill",
                        {"prompt_ids": [1, 2]}, None),
        "import_on_prefill": ("prefill", "/worker_import_chain",
                              {"handoff": ""}, None)}[case]
    want, got = _both(fleet, which, lambda a: _req(
        a, "POST", path, body, raw=raw)[:2])
    assert got == want and got[0] in (400, 403, 422)


def test_full_queue_sheds_503_with_retry_after(fleet):
    """A full bounded queue: 503, the page accounting in the body and a
    Retry-After, the same in both packages."""
    jm = fleet["model"]
    tm = fleet["torch"]["api"].server.model
    out = []
    for srv, wk in ((JServer(jm, max_queue=1, ragged_prefill=True, **KW),
                     jworker.LLMWorker),
                    (LLMServer(tm, max_queue=1, device="cpu", **KW),
                     LLMWorker)):
        srv.submit(np.arange(1, 6, dtype=np.int32), 2)   # never started
        w = wk(srv).start()
        st, body, hdrs = _req(w.address, "POST", "/worker_generate",
                              {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})
        out.append((st, body, int(hdrs["retry-after"]) >= 1))
        w.stop()
        srv.stop(drain=False)
    assert out[0] == out[1]
    assert out[1][0] == 503 and out[1][1]["pages_needed"] == 1


def _healthz(addr):
    st, body, _ = _req(addr, "GET", "/healthz")
    return st, body["status"], sorted(body), sorted(body.get(
        "watchdog", {}))


def test_healthz_and_stalled(fleet):
    want, got = _both(fleet, "api", _healthz)
    assert got == want and got[:2] == (200, "ok")
    out = []
    for side in ("jax", "torch"):
        srv = fleet[side]["api"].server
        srv.watchdog_enabled, srv.watchdog_tripped = True, True
        srv.watchdog_timeout, srv.watchdog_trips = 5.0, 1
        try:
            out.append(_healthz(fleet[side]["api"].address))
        finally:
            srv.watchdog_enabled = srv.watchdog_tripped = False
    assert out[0] == out[1] and out[1][:2] == (503, "stalled")
    assert out[1][3] == ["step_timeout_s", "tripped", "trips"]


def test_handoff_blob_byte_equal_and_cross_import(fleet):
    jm = fleet["model"]
    ids = list(range(40, 61))                   # 21 tokens: 2 full pages
    blobs = _both(fleet, "prefill", lambda a: _req(
        a, "POST", "/worker_prefill", {"prompt_ids": ids})[1])
    # the same wire: the JAX serializer re-packs the port blob's decoded
    # pages into the port blob byte for byte, and the two engines' K/V
    # agree to f32 rounding (the frameworks round differently)
    raw = [base64.b64decode(b["handoff"]) for b in blobs]
    jt, jk, jv, jh = jhandoff.deserialize_chain(raw[0])
    tt, tk, tv, th = jhandoff.deserialize_chain(raw[1])
    assert (tt, th, len(raw[1])) == (jt, jh, len(raw[0]))
    assert jhandoff.serialize_chain(tt, tk, tv, PAGE) == raw[1]
    np.testing.assert_allclose(np.stack(tk + tv), np.stack(jk + jv),
                               atol=1e-5, rtol=0)
    assert blobs[1]["output_ids"] == _golden(jm, ids, 1)
    assert blobs[1]["handoff_bytes"] == len(base64.b64decode(
        blobs[1]["handoff"]))
    for src in ("jax", "torch"):               # either package's blob
        for dst in ("jax", "torch"):
            addr = fleet[dst]["decode"].address
            st, body, _ = _req(addr, "POST", "/worker_import_chain",
                               {"handoff": blobs[src == "torch"]
                                ["handoff"]})
            assert (st, body) == (200, {"imported_pages": 2})
    got = _both(fleet, "decode", lambda a: _req(
        a, "POST", "/worker_generate",
        {"prompt_ids": ids, "max_new_tokens": 5})[1]["output_ids"])
    assert got[0] == got[1] == _golden(jm, ids, 5)
    assert fleet["torch"]["decode"].server._tier.fetches >= 2


def _openai(body):
    """The parts of an OpenAI body that do not carry ids or clocks."""
    return {"choices": body.get("choices"), "usage": body.get("usage"),
            "object": body.get("object"), "error": body.get("error")}


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": [5, 9, 2, 6], "max_tokens": 5}),
    ("/v1/completions", {"prompt": [104, 105], "max_tokens": 3, "n": 2}),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": "hi"}], "max_tokens": 4}),
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "ok?"}], "max_tokens": 3})])
def test_openai_plain_and_sse(fleet, path, body):
    want, got = _both(fleet, "api", lambda a: _req(a, "POST", path, body))
    assert (got[0], _openai(got[1])) == (want[0], _openai(want[1]))
    assert got[0] == 200
    ch = got[1]["choices"][0]
    text = ch["text"] if "text" in ch else ch["message"]["content"]
    assert text == ByteTokenizer().decode(ch["token_ids"]) if \
        "token_ids" in ch else isinstance(text, str)
    assert got[1]["usage"]["completion_tokens"] == \
        body["max_tokens"] * body.get("n", 1)
    # SSE: chunk boundaries follow the drain's timing; the joined ids
    # and text of each choice, the finish reasons and usage do not
    sse = _both(fleet, "api", lambda a: _joined(_sse(a, path, body)))
    assert sse[0] == sse[1]
    assert sse[1][1] == got[1]["usage"]
    assert [c[0] for c in sse[1][0]] == [c.get("token_ids") for c in
                                         got[1]["choices"]]


def _joined(chunks):
    """Per choice (ids, text, finish_reason) joined over an SSE stream,
    and the usage on its final chunk."""
    per = {}
    for c in chunks:
        for ch in c["choices"]:
            ids, text, fin = per.get(ch["index"], ([], "", None))
            delta = ch.get("delta", {})
            per[ch["index"]] = (ids + ch.get("token_ids", []),
                                text + ch.get("text", "")
                                + (delta.get("content") or ""),
                                ch.get("finish_reason") or fin)
    return [per[i] for i in sorted(per)], chunks[-1].get("usage")


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/v1/completions", {}),
    ("POST", "/v1/completions", {"model": "gpt-4o", "prompt": [1]}),
    ("POST", "/v1/completions", {"prompt": [1], "temperature": 0.7}),
    ("POST", "/v1/chat/completions", {"messages": "hi"}),
    ("GET", "/worker_drain", None), ("POST", "/worker_drain", {}),
    ("GET", "/metrics/snapshot", None), ("GET", "/metrics/query", None),
    ("GET", "/fleet/timeline", None), ("GET", "/alerts", None),
    ("GET", "/debug/kvcache", None), ("GET", "/debug/flight", None),
    ("GET", "/nope", None)])
def test_errors_and_unported_404s(fleet, method, path, body):
    want, got = _both(fleet, "api", lambda a: _req(a, method, path,
                                                   body)[:2])
    assert got == want and got[0] in (400, 404)


def test_models_and_disabled_gateway(fleet):
    want, got = _both(fleet, "api", lambda a: _req(a, "GET",
                                                   "/v1/models")[1])
    for b in (want, got):
        for m in b["data"]:
            m.pop("created")
    assert got == want
    want, got = _both(fleet, "plain", lambda a: _req(
        a, "POST", "/v1/completions", {"prompt": [1]})[:2])
    assert got == want and got[0] == 404


def test_metrics_and_status(fleet):
    st, text, hdrs = _req(fleet["torch"]["api"].address, "GET", "/metrics")
    assert st == 200 and hdrs["content-type"] == tobs.CONTENT_TYPE
    parsed = tobs.parse_prometheus(text)
    assert parsed["bigdl_llm_decode_tokens_total"][()] > 0
    want, got = _both(fleet, "api", lambda a: sorted(_req(
        a, "GET", "/worker_get_status")[1]))
    assert got == want


def test_unported_worker_switches_raise(fleet):
    """``fleet=True`` (once unported) serves ``/worker_drain``: the idle
    drain status, and a 400 on a bad action, as the JAX worker does;
    ``federation=True`` serves the member surface ``/metrics/snapshot``,
    which a worker without it answers 404."""
    srv = fleet["torch"]["api"].server
    out = []
    for side, wk in (("jax", jworker.LLMWorker), ("torch", LLMWorker)):
        w = wk(fleet[side]["api"].server, fleet=True).start()
        try:
            st, body, _ = _req(w.address, "GET", "/worker_drain")
            body.pop("age_s")
            out.append((st, body, _req(w.address, "POST", "/worker_drain",
                                       {"action": "nope"})[:2]))
        finally:
            w.stop()
    assert out[0] == out[1]
    assert out[1][0] == 200 and out[1][1]["state"] == "idle"
    assert out[1][2][0] == 400
    w = LLMWorker(srv, federation=True).start()
    try:
        st, doc, _ = _req(w.address, "GET", "/metrics/snapshot")
    finally:
        w.stop()
    addr = w.address
    assert st == 200 and doc["instance"] == f"{addr[0]}:{addr[1]}"
    assert "bigdl_build_info" in {m["name"] for m in doc["metrics"]}
    assert _req(fleet["torch"]["api"].address, "GET",
                "/metrics/snapshot")[0] == 404


def test_jax_router_over_port_worker(fleet):
    router = jworker.LLMRouter([], [fleet["torch"]["plain"].address],
                               start_prober=False).start()
    try:
        ids = PROMPTS[1]
        st, body, _ = _req(router.address, "POST", "/worker_generate",
                           {"prompt_ids": ids, "max_new_tokens": 7})
    finally:
        router.stop()
    assert st == 200 and body["output_ids"] == _golden(fleet["model"], ids, 7)
