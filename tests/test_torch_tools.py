"""The port's operator tools — ``bigdl_tpu_torch.tools.loadgen``,
``bigdl_tpu_torch.tools.fleet_report`` and the alerts / fleet chaos
drives of ``bigdl_tpu_torch.llm.chaos`` — on the CPU: their
deterministic outputs equal the JAX package's tools (``tools/``) on the
same seeds and snapshots, and the drives and the soak pass their own
contracts over tiny f32 engines."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bigdl_tpu.observability import federation as jfed
from bigdl_tpu.observability.metrics import MetricRegistry
from bigdl_tpu.observability.sketch import QuantileSketch as JSketch
from tools import fleet_report as jreport
from tools import loadgen as jloadgen

from bigdl_tpu_torch.llm import chaos
from bigdl_tpu_torch.llm.serving import LLMServer
from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker
from bigdl_tpu_torch.observability.sketch import QuantileSketch
from bigdl_tpu_torch.tools import fleet_report, loadgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ("bigdl_tpu_torch/tools/loadgen.py",
               "bigdl_tpu_torch/tools/fleet_report.py",
               "bigdl_tpu_torch/llm/chaos.py",
               "bigdl_tpu_torch/native/build.py",
               "bigdl_tpu_torch/native/quantize.py",
               "bigdl_tpu_torch/llm/ggml/quantize.py")


def test_new_modules_import_no_jax_nor_tools():
    """Neither an import of the new modules nor any import inside them
    (function-level ones included) reaches JAX, ``bigdl_tpu`` or the
    top-level ``tools``."""
    for path in NEW_MODULES:
        tree = ast.parse(open(os.path.join(REPO, path)).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "bigdl_tpu", "tools"), \
                    (path, n)
    code = ("import sys\n"
            "import bigdl_tpu_torch.tools.loadgen, "
            "bigdl_tpu_torch.tools.fleet_report, bigdl_tpu_torch.llm.chaos,"
            " bigdl_tpu_torch.native\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'bigdl_tpu', 'tools')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_prompts_and_classes_equal_jax():
    for n, seed, shared in ((7, 0, 0), (12, 3, 16)):
        got = loadgen.gen_prompts(n, seed=seed, shared_prefix=shared)
        want = jloadgen.gen_prompts(n, seed=seed, shared_prefix=shared)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    for spec in ("interactive:1,standard:1,batch:2", "batch",
                 " Standard:3 , interactive:0,"):
        mix = loadgen.parse_priority_mix(spec)
        assert mix == jloadgen.parse_priority_mix(spec)
        assert loadgen.assign_classes(11, mix) == \
            jloadgen.assign_classes(11, mix)
    for bad in ("fast:1", "", "batch:0", "batch:-1"):
        for mod in (loadgen, jloadgen):
            with pytest.raises(ValueError):
                mod.parse_priority_mix(bad)


def test_sketch_window_equals_jax():
    rs = np.random.RandomState(0)
    a, b = rs.lognormal(-3, 1, 300), rs.lognormal(-2, 1, 200)
    snaps = []
    for cls in (QuantileSketch, JSketch):
        sk = cls()
        for v in a:
            sk.observe(v)
        before = sk.to_snapshot()
        for v in b:
            sk.observe(v)
        snaps.append((before, sk.to_snapshot()))
    want = jloadgen.sketch_window(*snaps[1])
    assert loadgen.sketch_window(*snaps[0]) == want
    assert loadgen.sketch_window(*snaps[1]) == want
    assert loadgen.sketch_window(None, None) == \
        jloadgen.sketch_window(None, None)


def _snapshots():
    """Two members' snapshot documents written by the JAX federation."""
    docs = {}
    rs = np.random.RandomState(1)
    for i, name in enumerate(("10.0.0.1:8001", "10.0.0.2:8001")):
        reg = MetricRegistry()
        reg.counter("bigdl_llm_decode_tokens_total", "tokens").inc(
            17 + 5 * i)
        c = reg.counter("bigdl_router_failovers_total", "f", ("reason",))
        c.labels(reason="dispatch").inc(i + 1)
        for s in ("bigdl_router_ttft_seconds", "bigdl_llm_itl_seconds"):
            sk = reg.sketch(s, s)
            for v in rs.lognormal(-3, 0.5, 40 + 10 * i):
                sk.observe(v)
        docs[name] = jfed.registry_snapshot(reg, instance=name)
    return docs


def test_fleet_report_equals_jax(tmp_path, capsys):
    """``sketch_rows``, ``counter_table``, ``report`` (JSON and tables),
    ``load_snapshots``, ``timeline_report`` and the offline CLI print
    what the JAX tool prints."""
    snaps = _snapshots()
    assert fleet_report.sketch_rows(snaps) == jreport.sketch_rows(snaps)
    assert fleet_report.counter_table(snaps) == \
        jreport.counter_table(snaps)
    for as_json in (True, False):
        got = fleet_report.report(snaps, as_json=as_json)
        got_out = capsys.readouterr().out
        assert got == jreport.report(snaps, as_json=as_json)
        assert got_out == capsys.readouterr().out
    paths = []
    for name, doc in snaps.items():
        paths.append(str(tmp_path / (name.replace(":", "_") + ".json")))
        with open(paths[-1], "w") as f:
            json.dump(doc, f)
    assert fleet_report.load_snapshots(paths) == \
        jreport.load_snapshots(paths)
    assert fleet_report.main(paths + ["--json"]) == \
        jreport.main(paths + ["--json"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    doc = {"series": "bigdl_llm_decode_tokens_total", "samples": 3,
           "instances": {"a": [[0, 1.0], [1, 3.0], [2, 4.0]],
                         "b": [[0, 2.0], [1, None], [2, 2.5]]},
           "merged": [[0, 3.0], [1, 3.0], [2, 6.5]]}
    fleet_report.timeline_report(doc)
    got = capsys.readouterr().out
    jreport.timeline_report(doc)
    assert got == capsys.readouterr().out


@pytest.fixture
def fleet_of_two():
    """Two tiny f32 engines behind federated, api-enabled decode workers
    and a federated failover router with the gateway."""
    model = chaos.tiny_model("cpu")
    kw = dict(max_batch=2, max_seq_len=64, page_size=8, device="cpu")
    srvs = [LLMServer(model, slo=True, **kw).start() for _ in range(2)]
    workers = [LLMWorker(s, role="decode", federation=True,
                         api=True).start() for s in srvs]
    router = LLMRouter([], [w.address for w in workers], failover=True,
                       slo=True, federation=True, api=True,
                       start_prober=False).start()
    yield model, workers, router
    router.stop()
    for w in workers:
        w.stop()
    for s in srvs:
        s.stop()


def test_load_and_report_against_a_router(fleet_of_two, capsys):
    """``run_load`` through the router (blocking, the gateway's SSE and
    blocking) and streamed from a worker (the router has no native
    stream): no request lost, each index ``generate``'s answer to that
    prompt alone;
    the loadgen CLI; ``fleet_report --url``: the federated counters equal
    the members' sums; ``--timeline`` with the plane off names its gate."""
    model, workers, router = fleet_of_two
    prompts = loadgen.gen_prompts(6, seed=2, shared_prefix=8)
    budgets = [2 + (j % 3) for j in range(6)]
    want = [list(map(int, model.generate(p[None], max_new_tokens=b)
                     [0, len(p):])) for p, b in zip(prompts, budgets)]
    for addr, kw in ((router.address, {}),
                     (workers[0].address, {"stream": True}),
                     (router.address, {"openai": True, "stream": True}),
                     (router.address, {"openai": True})):
        res = loadgen.run_load(addr, prompts, max_new_tokens=budgets,
                               qps=50.0, **kw)
        assert res["lost"] == 0 and res["ok"] == 6, (kw, res["errors"])
        assert res["outputs"] == want, kw
    url = "%s:%d" % tuple(router.address)
    assert loadgen.main(["--url", url, "--requests", "3", "--max-new",
                         "2", "--qps", "50"]) == 0
    cli = json.loads(capsys.readouterr().out)
    assert cli["sent"] == cli["ok"] == 3 and cli["lost"] == 0
    router._collector.collect_now()
    assert fleet_report.main(["--url", url, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert len(rep["instances"]) >= 2
    rows = {r["name"]: r for r in rep["counters"]}
    assert rows["bigdl_llm_decode_tokens_total"]["sum"] == \
        rows["bigdl_llm_decode_tokens_total"]["federated"] > 0
    with pytest.raises(RuntimeError, match="timeseries.enabled"):
        fleet_report.fetch_timeline(router.address,
                                    "bigdl_llm_decode_tokens_total")


def test_openai_bench():
    out = loadgen.run_openai_bench(n_requests=2, max_new=3, device="cpu")
    assert out["output_mismatches"] == 0 and out["requests"] == 2
    assert out["ttft_direct_p50_ms"] > 0 and out["ttft_gateway_p50_ms"] > 0


def test_fleet_micro():
    out = fleet_report.run_fleet_micro(device="cpu")
    assert out["succeeded"] == out["requests"] == 6
    assert out["counter_additive"] and len(out["members"]) == 2


def test_alerts_chaos_contract():
    out = chaos.run_alerts_chaos(device="cpu", smoke=True)
    assert out["match"] and out["alert_events"] == {"fire": 1,
                                                    "resolve": 1}
    assert out["autoscaler_decisions"] == "identical"


def test_fleet_chaos_contract():
    out = chaos.run_fleet_chaos(device="cpu", smoke=True)
    assert out["lost_requests"] == 0 and out["converged_workers"] == 1
    assert out["scale_outs"] >= 2 and out["drains_lost"] >= 1
    assert out["chains_migrated"] > 0 and out["failovers"] >= 1


def test_fleet_soak_contract():
    out = loadgen.run_fleet_soak(device="cpu", model=chaos.tiny_model("cpu"))
    assert out["requests_lost"] == 0 and out["converged_workers"] == 1
    assert out["scale_outs"] >= 1 and out["scale_ins"] >= 1


def test_chaos_cli(monkeypatch, capsys):
    """The CLI runs the chosen drive with its flags and exits 1 when the
    drive's contract breaks."""
    calls = []

    def drive(**kw):
        calls.append(kw)
        if kw["seed"] == 7:
            raise AssertionError("lost 1 request")
        return {"match": True, "outputs": [[1]]}

    monkeypatch.setitem(chaos.DRIVES, "fleet", drive)
    assert chaos.main(["--fleet", "--smoke", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "drive": "fleet", "ok": True, "match": True}
    assert chaos.main(["--fleet", "--seed", "7"]) == 1
    assert json.loads(capsys.readouterr().out)["ok"] is False
    assert calls == [dict(seed=0, smoke=True, device="cpu"),
                     dict(seed=7, smoke=False, device=None)]
    with pytest.raises(SystemExit):
        chaos.main(["--fleet", "--alerts"])


def test_fleet_soak_samples_the_spike_between_its_own_ticks(monkeypatch):
    """The soak's own loop ticks once as the spike starts and then sleeps
    far past it: the scale-out must come from the ticks the load
    generator makes while the spike's requests are outstanding."""
    monkeypatch.setattr(loadgen, "SOAK_TICK_S", 1.5)
    out = loadgen.run_fleet_soak(device="cpu", model=chaos.tiny_model("cpu"))
    assert out["requests_lost"] == 0 and out["converged_workers"] == 1
    assert out["scale_outs"] >= 1 and out["scale_ins"] >= 1
