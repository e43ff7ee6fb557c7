"""The port's ``LLMServer`` (paged decode + whole-prompt ragged prefill,
pipelined dispatch) against the JAX package's engine, plus the port's
rules: greedy outputs are token-identical to the JAX ``LLMServer`` on
``LlamaConfig.tiny()`` q4_0 (f32 params and f32 KV, so argmax near-ties
cannot flip); pages and budget come back when requests finish; the
options the port does not implement raise ``NotImplementedError`` and
the host tier's build the engine; and no module of ``bigdl_tpu_torch`` imports JAX or ``bigdl_tpu``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.llm.serving import LLMServer as JServer

from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer, OverloadError

PAGE = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    """The same f32 q4_0 tiny weights as a JAX model and a port model."""
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


def _workload():
    """5 overlapping requests of different lengths (prompts cross page
    boundaries; max_batch=2 forces queueing and slot reuse)."""
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 250, n).astype(np.int32)
               for n in (5, 17, 9, 30, 12)]
    return prompts, [6, 4, 8, 5, 7]


def _serve(srv, prompts, lens):
    srv.start()
    try:
        return [r.get(timeout=600) for r in
                [srv.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, lens)]]
    finally:
        srv.stop()


class TestEngineParity:
    def test_greedy_token_identical_to_jax(self, pair):
        jm, tm = pair
        prompts, lens = _workload()
        want = _serve(JServer(jm, max_batch=2, max_seq_len=64,
                              page_size=PAGE, ragged_prefill=True,
                              pipeline_depth=1), prompts, lens)
        srv = LLMServer(tm, max_batch=2, max_seq_len=64, page_size=PAGE,
                        device="cpu")
        got = _serve(srv, prompts, lens)
        assert got == want
        assert srv.errors == []
        # every page and the whole budget came back
        assert srv.pages_in_use == 0
        assert len(srv._free) == srv._num_pages - 1
        assert srv._budget_avail == srv._num_pages - 1

    def test_eos_finishes_early(self, pair):
        jm, tm = pair
        prompts, lens = _workload()
        base = _serve(LLMServer(tm, max_batch=2, max_seq_len=64,
                                page_size=PAGE, device="cpu"),
                      prompts[:1], [8])[0]
        # the first token after the first that did not occur before it
        j = next(i for i in range(1, len(base)) if base[i] not in base[:i])
        eos = base[j]
        want = _serve(JServer(jm, max_batch=2, max_seq_len=64,
                              page_size=PAGE, ragged_prefill=True,
                              pipeline_depth=1, eos_token_id=eos),
                      prompts[:1], [8])
        got = _serve(LLMServer(tm, max_batch=2, max_seq_len=64,
                               page_size=PAGE, eos_token_id=eos,
                               device="cpu"), prompts[:1], [8])
        assert got == want and got[0] == base[:j + 1]

    def test_alone_equals_batched(self, pair):
        """Every step runs all max_batch rows, so a request's tokens do
        not depend on its neighbours: served alone = served in a batch."""
        _, tm = pair
        prompts, lens = _workload()
        batched = _serve(LLMServer(tm, max_batch=4, max_seq_len=64,
                                   page_size=PAGE, device="cpu"),
                         prompts, lens)
        alone = _serve(LLMServer(tm, max_batch=4, max_seq_len=64,
                                 page_size=PAGE, device="cpu"),
                       prompts[3:4], lens[3:4])
        assert alone[0] == batched[3]

    def test_sampled_contract(self, pair):
        """Sampled decode: in-vocab tokens of the asked count, and the
        same seed gives the same tokens."""
        _, tm = pair
        prompts, lens = _workload()
        runs = [_serve(LLMServer(tm, max_batch=2, max_seq_len=64,
                                 page_size=PAGE, temperature=0.9, top_k=5,
                                 sample_seed=11, device="cpu"),
                       prompts, lens) for _ in range(2)]
        assert runs[0] == runs[1]
        for toks, n in zip(runs[0], lens):
            assert len(toks) == n and all(0 <= t < 256 for t in toks)


class TestPipelinedEngine:
    """The port of ``TestPipelinedEngine``: the dispatch window changes
    throughput, never tokens; depth 1 is the synchronous engine; steps
    dispatched past a request's end stay inside its budget."""

    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_greedy_parity_across_depths(self, pair, depth):
        jm, tm = pair
        prompts, lens = _workload()
        gen = [tm.generate(p[None], max_new_tokens=n)[0, len(p):].tolist()
               for p, n in zip(prompts, lens)]
        kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE,
                  pipeline_depth=depth)
        want = _serve(JServer(jm, ragged_prefill=True, **kw), prompts, lens)
        srv = LLMServer(tm, device="cpu", **kw)
        got = _serve(srv, prompts, lens)
        assert got == want == gen and srv.errors == []
        assert srv.pages_in_use == 0
        assert srv._budget_avail == srv._num_pages - 1
        assert sorted(srv._free) == list(range(1, srv._num_pages))
        assert not srv._inflight and not srv._pending_release

    @pytest.mark.parametrize("depth", [1, 2])
    def test_device_tables_follow_the_host(self, pair, depth):
        """Driven inline: after every pass the device tables equal the
        host's view, and at depth 1 nothing is left in flight."""
        _, tm = pair
        prompts, lens = _workload()
        srv = LLMServer(tm, max_batch=2, max_seq_len=64, page_size=PAGE,
                        pipeline_depth=depth, device="cpu")
        reqs = [srv.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, lens)]
        while not all(r.done.is_set() for r in reqs):
            srv._admit()
            srv._step_paged()
            assert len(srv._inflight) < depth
            np.testing.assert_array_equal(srv._bt_dev.numpy(), srv._bt)
            np.testing.assert_array_equal(srv._lens_dev.numpy(), srv._lens)

    def test_small_pool_stays_inside_budget(self, pair):
        """A pool of 5 pages (2 requests' worst case) under 4 slots at
        depth 4, with queued waiters: exact greedy output and no page
        granted past the budget (the free list would raise)."""
        _, tm = pair
        prompts = [np.arange(1, 9, dtype=np.int32) for _ in range(6)]
        want = tm.generate(prompts[0][None], max_new_tokens=8)[0, 8:]
        srv = LLMServer(tm, max_batch=4, max_seq_len=32, page_size=PAGE,
                        num_pages=5, pipeline_depth=4, device="cpu")
        got = _serve(srv, prompts, [8] * 6)
        assert got == [want.tolist()] * 6 and srv.errors == []
        assert srv._budget_avail == srv._num_pages - 1
        assert sorted(srv._free) == list(range(1, srv._num_pages))

    def test_eos_discards_the_token_in_flight(self, pair):
        _, tm = pair
        prompts, _ = _workload()
        base = _serve(LLMServer(tm, max_batch=2, max_seq_len=64,
                                page_size=PAGE, device="cpu"),
                      prompts[:1], [8])[0]
        j = next(i for i in range(1, len(base)) if base[i] not in base[:i])
        srv = LLMServer(tm, max_batch=2, max_seq_len=64, page_size=PAGE,
                        eos_token_id=base[j], pipeline_depth=4,
                        device="cpu")
        assert _serve(srv, prompts[:1], [8])[0] == base[:j + 1]
        # steps went on past the EOS until it drained; their tokens were
        # discarded and their pages came back
        assert srv.steps == min(8, j + 4)
        assert srv.pages_in_use == 0 and not srv._inflight


def test_capture_adds_no_launches():
    """What a capture launches is its delta, the capture itself adds
    nothing, and each replay adds the delta."""
    from bigdl_tpu_torch.llm import kernels
    kernels.reset_launch_counts()
    with kernels.launches_of_capture() as delta:
        kernels.int4_matmul.launches += 5
        kernels.int4_matmul.tc_launches += 1
        kernels.paged_attention_decode_stats.launches += 2
    assert delta == {"int4_matmul": 5, "int4_matmul_tc": 1,
                     "paged_attention_decode_stats": 2}
    assert not any(kernels.launch_counts().values())
    for _ in range(3):
        kernels.add_launches(delta)
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        k: 3 * v for k, v in delta.items()}


def test_capture_carries_gemv_launches():
    """The GEMV's counters (``<wrapper>_gemv``) go through a capture's
    delta and each replay like the others."""
    from bigdl_tpu_torch.llm import kernels
    kernels.reset_launch_counts()
    with kernels.launches_of_capture() as delta:
        for w in kernels.GEMV_WRAPPERS:
            w.launches += 3
            w.gemv_launches += 2
    assert delta == {k: v for w in kernels.GEMV_WRAPPERS for k, v in (
        (w.__name__, 3), (f"{w.__name__}_gemv", 2))}
    assert not any(kernels.launch_counts().values())
    kernels.add_launches(delta)
    kernels.add_launches(delta)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        k: 2 * v for k, v in delta.items()}


class TestEngineRules:
    @pytest.mark.parametrize("opt", [
        {"bigdl.observability.timeseries.enabled": "true"},
        {"bigdl.observability.federation": "true"}])
    def test_unsupported_options_raise(self, pair, opt):
        """``slo=`` and ``watchdog_timeout=`` are ported; the planes the
        port still lacks raise when their switch is on, naming their
        ROADMAP item."""
        from bigdl_tpu_torch.utils.conf import conf
        _, tm = pair
        (key, value), = opt.items()
        conf.set(key, value)
        try:
            with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
                LLMServer(tm, device="cpu")
        finally:
            conf.unset(key)

    @pytest.mark.parametrize("opt,slots", [
        ({"kvcache": True, "kvtier": True}, 4 * 17),
        ({"kvcache": True, "kvtier": True, "host_pages": 4}, 4),
        ({"kvcache": True, "kvtier": True, "kvtier_sync": True,
          "kvtier_fetch_timeout": 5.0}, 4 * 17),
        ({"host_pages": 4}, None)])
    def test_tier_options_construct(self, pair, opt, slots):
        """The host tier's options build an engine as the JAX engine's
        do: ``host_pages`` slots (default 4 x ``num_pages``), no tier
        without ``kvtier`` (``host_pages`` alone is inert)."""
        jm, tm = pair
        kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE)
        srv = LLMServer(tm, device="cpu", **kw, **opt)
        assert srv._num_pages == 17
        if slots is None:
            assert srv._tier is None and srv._kv.tier is None
        else:
            assert srv._kv.tier is srv._tier
            assert srv._tier.arena.capacity == slots
            assert srv._tier.migrator.synchronous == bool(
                opt.get("kvtier_sync"))
            assert srv._tier.fetch_timeout == opt.get(
                "kvtier_fetch_timeout", 30.0)
            ref = JServer(jm, ragged_prefill=True, **kw, **{
                k: v for k, v in opt.items() if not k.startswith("kvtier_")})
            assert ref._tier.arena.capacity == slots
            ref.stop()
        srv.stop()

    def test_page_size_follows_the_model(self, pair):
        _, tm = pair
        assert LLMServer(tm, device="cpu")._page == tm.page_size == PAGE
        with pytest.raises(ValueError, match="page_size"):
            LLMServer(tm, page_size=2 * PAGE, device="cpu")

    def test_unknown_option_is_a_type_error(self, pair):
        _, tm = pair
        with pytest.raises(TypeError):
            LLMServer(tm, device="cpu", no_such_option=1)

    def test_needs_a_device(self, pair, monkeypatch):
        _, tm = pair
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMServer(tm)

    def test_submit_validation(self, pair):
        _, tm = pair
        srv = LLMServer(tm, max_batch=2, max_seq_len=32, page_size=PAGE,
                        max_queue=1, device="cpu")
        with pytest.raises(ValueError):
            srv.submit(np.arange(30), max_new_tokens=8)
        with pytest.raises(ValueError):
            srv.submit(np.arange(3), max_new_tokens=0)
        srv.submit(np.arange(3), max_new_tokens=2)      # not started
        with pytest.raises(OverloadError):
            srv.submit(np.arange(3), max_new_tokens=2)
        srv.stop(drain=False)

    def test_default_pool_size(self, pair):
        """Page 0 is trash; default num_pages = 1 + max_batch *
        ceil(max_seq_len / page); tables keep the JAX engine's width."""
        jm, tm = pair
        srv = LLMServer(tm, max_batch=3, max_seq_len=40, page_size=PAGE,
                        device="cpu")
        ref = JServer(jm, max_batch=3, max_seq_len=40, page_size=PAGE,
                      ragged_prefill=True, pipeline_depth=1)
        assert srv._num_pages == 1 + 3 * 5 == ref._num_pages
        assert srv._pages_cap == ref._pages_cap
        assert tuple(srv._k_pages.shape) == tuple(ref._k_pages.shape)
        ref.stop()


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor any
    ``bigdl_tpu`` module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bigdl_tpu_torch\n"
        "for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,\n"
        "                               'bigdl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'bigdl_tpu' or n.startswith('bigdl_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('bigdl_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
