"""The port's federation, capture records and live roofline
(``observability/{federation,compile_recorder,utilization}.py``) against
the JAX package's: snapshots, merge and render byte for byte; the
collector; each package's collector over the other's surface; a
federated port router over live port workers; ``utilization`` under the
same injected costs and peaks; and every switch off: nothing there."""

import contextlib
import http.client
import json
import threading
import time

import numpy as np
import pytest

from bigdl_tpu import observability as jobs
from bigdl_tpu.observability import compile_recorder as jcr
from bigdl_tpu.observability import federation as jfed
from bigdl_tpu.observability import utilization as jutil
from bigdl_tpu.observability.metrics import MetricRegistry as JReg
from bigdl_tpu.utils.conf import conf as jconf

from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch import reliability as trel
from bigdl_tpu_torch.llm.chaos import tiny_model
from bigdl_tpu_torch.llm.serving import LLMServer
from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker
from bigdl_tpu_torch.observability import compile_recorder as tcr
from bigdl_tpu_torch.observability import federation as tfed
from bigdl_tpu_torch.observability import utilization as tutil
from bigdl_tpu_torch.observability.metrics import MetricRegistry as TReg
from bigdl_tpu_torch.utils.conf import conf as tconf

GATE = "bigdl.observability.flight.enabled"
PEAKS = {"bigdl.device.peak.tflops": "100", "bigdl.device.peak.gbps": "800"}
SIDES = {"jax": (jobs, jfed, JReg, jutil, jcr, jconf),
         "torch": (tobs, tfed, TReg, tutil, tcr, tconf)}
KW = dict(max_batch=2, max_seq_len=64, page_size=8, device="cpu")


def _req(addr, method, path, body=None, timeout=60):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None)
        r = conn.getresponse()
        raw = r.read().decode()
        try:
            return r.status, json.loads(raw)
        except ValueError:
            return r.status, raw
    finally:
        conn.close()


@contextlib.contextmanager
def _stack():
    """``up(x)`` starts ``x``; everything started is stopped, last first,
    on the way out."""
    with contextlib.ExitStack() as stack:
        def up(x):
            x = x.start()
            stack.callback(x.stop)
            return x
        yield up


def _registry(Reg, counter=0.0, gauge=None, sketch_vals=(), hist_vals=(),
              alpha=0.01, buckets=None):
    reg = Reg()
    if counter:
        reg.counter("bigdl_llm_decode_tokens_total", "t").inc(counter)
    if gauge is not None:
        reg.gauge("bigdl_llm_active_slots", "t").set(gauge)
    if sketch_vals:
        sk = reg.sketch("bigdl_router_ttft_seconds", "t", alpha=alpha)
        for v in sketch_vals:
            sk.observe(v)
    if hist_vals:
        h = reg.histogram("bigdl_llm_prefill_seconds", "t",
                          **({"buckets": buckets} if buckets else {}))
        for v in hist_vals:
            h.observe(v)
    lab = reg.counter("bigdl_router_hedges_total", "h",
                      labelnames=("stage", "outcome"))
    lab.labels(stage="decode", outcome="issued").inc(2)
    return reg


def _strip(doc):
    return {k: v for k, v in doc.items() if k != "ts"}


MEMBERS = {
    "counters": ({"counter": 10}, {"counter": 5}),
    "gauges": ({"gauge": 2}, {"gauge": 3}),
    "histograms": ({"hist_vals": (0.01,)}, {"hist_vals": (0.02, 5.0)}),
    "bounds_mismatch": ({"hist_vals": (0.01,)},
                        {"hist_vals": (0.3,), "buckets": (0.1, 1.0)}),
    "sketches": ({"sketch_vals": (0.01, 0.02, 0.5)},
                 {"sketch_vals": (0.03, 0.04)}),
    "alpha_mismatch": ({"sketch_vals": (0.1,)},
                       {"sketch_vals": (0.2,), "alpha": 0.05}),
    "mixed": ({"counter": 2, "gauge": 1, "sketch_vals": (0.1, 0.2)},
              {"counter": 3, "hist_vals": (0.7,)})}


@pytest.mark.parametrize("case", sorted(MEMBERS))
def test_snapshot_merge_render_byte_equal(case):
    docs = {}
    for side, (_, fed, Reg, *_rest) in SIDES.items():
        docs[side] = {name: fed.registry_snapshot(_registry(Reg, **kw),
                                                  instance=name)
                      for name, kw in zip("ab", MEMBERS[case])}
    assert {k: _strip(v) for k, v in docs["torch"].items()} == \
        {k: _strip(v) for k, v in docs["jax"].items()}
    # each package's merge of the other's documents
    jm, tm = jfed.merge_snapshots(docs["torch"]), \
        tfed.merge_snapshots(docs["jax"])
    assert _strip(tm) == _strip(jm)
    text = tfed.render_merged(tm)
    assert text == jfed.render_merged(jm)
    parsed = tobs.parse_prometheus(text)
    assert parsed["bigdl_router_hedges_total"][
        (("outcome", "issued"), ("stage", "decode"))] == 4.0


def test_collector_sweep_stale_fault_and_departure():
    tobs.counter("bigdl_federation_test_total", "t").inc(3)
    servers = [tfed.SnapshotServer(instance=f"m{i}").start()
               for i in range(2)]
    targets = [(f"m{i}", s.address) for i, s in enumerate(servers)]
    col = tfed.FederationCollector(lambda: list(targets), interval=3600,
                                   include_self="router")
    was = trel.enabled()
    trel.enable()
    try:
        col.collect_now()
        st = col.status()
        assert st["stale"] == 0 and set(st["members"]) == {"m0", "m1"}
        m = tobs.parse_prometheus(col.render())
        local = tobs.REGISTRY.sample_value("bigdl_federation_test_total")
        assert m["bigdl_federation_test_total"][()] == 3 * local
        trel.set_plan(trel.FaultPlan(seed=0).add("federation.scrape",
                                                 "raise", times=1))
        col.collect_now()
        assert col.status()["members"]["m0"]["stale"] is True
        assert col.stale_instances() == {"m0"}
        trel.set_plan(None)
        servers[1].stop()
        col.collect_now()
        st = col.status()["members"]
        assert st["m0"]["stale"] is False and st["m1"]["stale"] is True
        # a stale member keeps serving its last-known snapshot
        assert "m1" in col.snapshots()
        targets.pop()
        col.collect_now()
        assert set(col.status()["members"]) == {"m0"}
        scrapes = tobs.parse_prometheus(tobs.render())[
            "bigdl_federation_scrapes_total"]
        assert scrapes[(("outcome", "error"),)] >= 2
    finally:
        trel.set_plan(None)
        if not was:
            trel.disable()
        servers[0].stop()
    col.start()
    assert any(t.name == col.THREAD_NAME for t in threading.enumerate())
    col.stop()
    assert not any(t.name == col.THREAD_NAME for t in threading.enumerate())


def test_collectors_across_packages():
    """Each package's collector over the other's snapshot surface: the
    same merged fleet document."""
    servers = {"jax": jfed.SnapshotServer(instance="j").start(),
               "torch": tfed.SnapshotServer(instance="t").start()}
    try:
        merged = {}
        for side in ("jax", "torch"):
            targets = [("t", servers["torch"].address),
                       ("j", servers["jax"].address)]
            col = SIDES[side][1].FederationCollector(lambda: targets,
                                                     interval=3600)
            col.collect_now()
            assert col.status()["stale"] == 0
            merged[side] = col.merged()
        for doc in merged.values():
            # each sweep counts itself into the registry it scrapes
            doc["metrics"] = [m for m in doc["metrics"] if not
                              m["name"].startswith("bigdl_federation_")]
        assert _strip(merged["torch"]) == _strip(merged["jax"])
        assert _build_instances(merged["torch"]) == {"j", "t"}
    finally:
        for s in servers.values():
            s.stop()


def _build_instances(doc):
    """The instances whose build gauge the merged document carries."""
    (m,) = [m for m in doc["metrics"] if m["name"] == "bigdl_build_info"]
    return {s["labels"][-1] for s in m["series"]}


@pytest.fixture(scope="module")
def model():
    return tiny_model("cpu")


def test_federated_router_over_live_workers(model):
    with _stack() as up:
        srvs = [up(LLMServer(model, slo=True, **KW)) for _ in range(2)]
        ws = [up(LLMWorker(s, role="decode", federation=True)) for s in srvs]
        r = up(LLMRouter([], [w.address for w in ws], failover=True,
                         slo=True, federation=True, start_prober=False))
        rs = np.random.RandomState(0)
        for j in range(4):
            p = rs.randint(0, 250, 8 + 2 * j).tolist()
            st, body = _req(r.address, "POST", "/worker_generate",
                            {"prompt_ids": p, "max_new_tokens": 3})
            assert st == 200 and len(body["output_ids"]) == 3
        # the drain counts a step's tokens after its request answered:
        # read once the count has settled
        name = "bigdl_llm_decode_tokens_total"
        deadline = time.monotonic() + 10
        while True:
            local = tobs.REGISTRY.sample_value(name)
            snaps = [_req(w.address, "GET", "/metrics/snapshot")[1]
                     for w in ws]
            per = [sum(s["value"] for d in snap["metrics"]
                       if d["name"] == name for s in d["series"])
                   for snap in snaps]
            if per == [local, local] and not any(
                    x._inflight or any(x._slots) for x in srvs):
                break
            assert time.monotonic() < deadline
            time.sleep(0.02)
        r._collector.collect_now()
        st, status = _req(r.address, "GET", "/fleet/status")
        text = _req(r.address, "GET", "/metrics")[1]
    assert st == 200 and status["stale"] == 0
    assert set(status["members"]) == {f"{w.address[0]}:{w.address[1]}"
                                      for w in ws}
    # two members and the router itself, all this process's registry
    fed = tobs.parse_prometheus(text)[name][()]
    assert fed == sum(per) + local == 3 * local


def test_disabled_federation_structurally_absent(model):
    before = set(tobs.render().splitlines())
    with _stack() as up:
        w = up(LLMWorker(up(LLMServer(model, **KW)), role="decode"))
        r = up(LLMRouter([], [w.address], start_prober=False))
        assert r._collector is None and not w.federation
        assert _req(w.address, "GET", "/metrics/snapshot")[0] == 404
        assert _req(r.address, "GET", "/fleet/status")[0] == 404
        text = _req(r.address, "GET", "/metrics")[1]
    assert "bigdl_federation_" not in "\n".join(
        set(text.splitlines()) - before)
    assert not any(t.name == tfed.FederationCollector.THREAD_NAME
                   for t in threading.enumerate())


# ---------------------------------------------------------------------------
# live roofline and capture records
# ---------------------------------------------------------------------------

@pytest.fixture()
def roofline(monkeypatch):
    """Both packages reset, flight on and the peaks pinned; restored."""
    for obs, _, _, util, _, conf in SIDES.values():
        obs.reset()
        conf.set(GATE, "true")
        for k, v in PEAKS.items():
            conf.set(k, v)
    yield monkeypatch
    for obs, _, _, util, _, conf in SIDES.values():
        for k in (GATE, *PEAKS):
            conf.unset(k)
        obs.reset()


def _roof(util, obs, calls):
    for fn, wall in calls:
        util.observe(fn, wall)
    snap = util.snapshot()
    snap.pop("device")
    return snap, [obs.REGISTRY.sample_value(n) for n in (
        "bigdl_device_mfu", "bigdl_device_hbm_bw_gbps",
        "bigdl_device_bw_util")]


@pytest.mark.parametrize("costs,calls", [
    ({"llm/decode_paged": (2e9, 4e8)}, [("llm/decode_paged", 0.001)] * 10),
    ({"llm/step_mixed": (2e12, 1e9)}, [("llm/step_mixed", 0.1)]),
    ({"known": (0.0, 4e8)}, [("known", 0.001), ("mystery", 10.0)]),
    ({"llm/decode_paged": (2e9, 4e8), "llm/step_spec": (3e9, 5e8)},
     [("llm/decode_paged", 0.008), ("llm/step_spec", 0.014)] * 3)])
def test_utilization_equal_under_injected_costs(roofline, costs, calls):
    out = []
    for side in ("jax", "torch"):
        obs, _, _, util, cr, _ = SIDES[side]
        roofline.setattr(cr, "latest_costs", lambda: dict(costs))
        out.append(_roof(util, obs, calls))
    assert out[0] == out[1]
    assert out[1][0]["samples"] == len(calls)


def test_utilization_attended_keys(roofline):
    """A paged step's cost grows with the keys it attends: ``attn``
    adds its per-key bytes and per-pair FLOPs to the fixed cost."""
    roofline.setattr(tcr, "latest_costs",
                     lambda: {"llm/decode_paged": (2e9, 4e8)})
    roofline.setattr(tcr, "attn_costs",
                     lambda: {"llm/decode_paged": (1e3, 2e5)})
    for _ in range(4):
        tutil.observe("llm/decode_paged", 0.001, attn=(1000, 1000))
    (row,) = tutil.roofline_table()
    assert row["bytes_per_call"] == 4e8 + 2e5 * 1000
    assert row["flops_per_call"] == 2e9 + 1e3 * 1000
    assert tobs.REGISTRY.sample_value("bigdl_device_hbm_bw_gbps") == \
        pytest.approx(600.0)
    assert tobs.REGISTRY.sample_value("bigdl_device_bw_util") == \
        pytest.approx(0.75)


def test_utilization_gated_off_and_peaks():
    assert not tutil.flight.enabled
    lines = set(tobs.render().splitlines())
    tutil.observe("llm/decode_paged", 0.01)
    snap = tutil.snapshot()
    assert snap["samples"] == 0 and snap["programs"] == []
    assert "mfu" not in snap and set(tobs.render().splitlines()) == lines
    # no CUDA device and no override: both axes unknown, as in JAX on CPU
    assert tutil.peaks() == jutil.peaks() == (None, None)
    assert [k for k, *_ in tutil.PEAK_SPECS][-1] == "h100"
    assert tutil.PEAK_SPECS[-1][1:] == (989.0, 3350.0)


def test_capture_records_series_and_cpu(roofline, model):
    """The capture records keep the JAX series names, kinds and labels;
    a capture lands one ledger entry; the CPU captures nothing, and the
    engine's drain feeds the roofline table under the JAX names."""
    tcr.record_capture("llm/decode_paged", 0.25, 3 << 20,
                       {"int4_matmul": 129},
                       costs={"flops": 2e9, "bytes": 4e8,
                              "attn_flops": 1e3, "kv_bytes": 2e5},
                       signature="B=8 S=512")
    (rec,) = tcr.compile_stats()
    assert (rec["fn"], rec["compiles"], rec["recompiles"]) == \
        ("llm/decode_paged", 1, 0)
    assert rec["history"][0]["pool_bytes"] == 3 << 20
    assert tcr.latest_costs() == {"llm/decode_paged": (2e9, 4e8)}
    assert tcr.attn_costs() == {"llm/decode_paged": (1e3, 2e5)}
    j, t = jcr._instruments(), tcr._instruments()
    assert sorted(j) == sorted(t)
    for k in j:
        assert (t[k].name, t[k].kind, t[k].labelnames) == \
            (j[k].name, j[k].kind, j[k].labelnames)
    tobs.reset()
    tconf.set(GATE, "true")
    with _stack() as up:
        srv = up(LLMServer(model, **KW))
        w = up(LLMWorker(srv, federation=True))
        for n in (3, 4):
            srv.submit(np.arange(1, 1 + 2 * n, dtype=np.int32),
                       n).get(timeout=60)
        doc = _req(w.address, "GET", "/metrics/snapshot")[1]
    assert tcr.compile_stats() == []          # nothing captured on the CPU
    rows = {r["fn"]: r for r in doc["roofline"]["programs"]}
    assert rows["llm/decode_paged"]["calls"] >= 5
    assert doc["roofline"]["device"] == "cpu"
    assert isinstance(srv._decode.costs["bytes"], float) and \
        srv._decode.name == "llm/decode_paged"
