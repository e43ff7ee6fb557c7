"""The port's mixed prefill+decode dispatch with chunked admission and
its prefix cache in the engine, against the JAX package (tiny q4_0,
f32 params and KV, page 8, chunks of one page): the mixed step against
``make_mixed_step``; greedy tokens equal to the JAX ``generate`` golden,
and every engine counter and the page order equal to the JAX engine
driven the same way, over kvcache on/off x mixed on/off x depth 1/2;
the dense staging prefill (``ragged_prefill=False``); a COW fork across
chunks beside a live decode row on the same prefix; and the rollback of
a chunked admission shed for want of budget."""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.kvcache.prefill import make_mixed_step as j_mixed
from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.llm.serving import LLMServer as JServer
from bigdl_tpu.llm.serving import paged_decode_step as j_decode

from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer

PAGE = 8
CHUNK = 8         # one page per chunk: every long prompt really chunks


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


def _golden(jm, prompts, lens):
    return [list(map(int, jm.generate(p[None], max_new_tokens=n)[0, len(p):]))
            for p, n in zip(prompts, lens)]


@pytest.mark.parametrize("off,tail", [(0, False), (13, True)])
def test_mixed_step_matches_jax(pair, off, tail):
    """One mixed step on the same pools and operands: a 5-token chunk
    at ``off`` (with a COW fork of page 6 into page 3 when ``tail``)
    beside 3 decode rows and an inactive one. Sampled ids equal; logits,
    ``clast``, lengths and every real page within 1e-5."""
    jm, tm = pair
    cfg = tm.config
    rs = np.random.RandomState(off)
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    kp, vp = (rs.randn(L, 12, Hkv, PAGE, D).astype(np.float32)
              for _ in range(2))
    bt = np.array([[1, 2, 0, 0], [4, 5, 0, 0], [0] * 4, [7, 8, 0, 0]],
                  np.int32)
    lens = np.array([9, 15, 0, 3], np.int32)
    last = rs.randn(4, cfg.vocab_size).astype(np.float32)
    active = np.array([True, True, False, True])
    bucket, c = 8, 5
    ctoks = np.zeros((1, bucket), np.int32)
    ctoks[0, :c] = rs.randint(0, 256, c)
    cbt = np.array([9, 10, 3, 11], np.int32)
    pos = off + np.arange(bucket)
    cphys = np.where(pos < off + c, cbt[np.minimum(pos // PAGE, 3)],
                     0).astype(np.int32)
    cslots = (pos % PAGE).astype(np.int32)
    fork = (3, 6) if tail else (0, 0)
    args = (bt, lens, last, active)
    chunk = (ctoks, c, off, cbt, cphys, cslots) + fork
    out, wl, wk, wv, wlen, _, wc = j_mixed(j_decode,
                                           jllama.paged_prefill_ragged)(
        jm.params, jm.config, jnp.asarray(kp), jnp.asarray(vp),
        *map(jnp.asarray, args), 1.0, jax.random.PRNGKey(0),
        *(jnp.asarray(a, jnp.int32) for a in chunk), page=PAGE)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    toks, gl, gk, gv, glen, gc = tllama.paged_step_mixed(
        tm.params, cfg, tk, tv, *map(t, args), 1.0, None,
        *(t(np.asarray(a, np.int32)) for a in chunk), page=PAGE)
    assert gk is tk and gv is tv                       # in place
    np.testing.assert_array_equal(toks.numpy(), np.asarray(out)[:4])
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    for g, w in ((gl, wl), (gc, wc), (gk[:, 1:], np.asarray(wk)[:, 1:]),
                 (gv[:, 1:], np.asarray(wv)[:, 1:])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def _workload():
    """Long prompts (chunked at CHUNK) and short ones, sharing a prefix
    (tests/test_mixed_dispatch.py's)."""
    rs = np.random.RandomState(14)
    shared = rs.randint(0, 250, 20).astype(np.int32)     # 2.5 pages
    prompts = [np.concatenate(
        [shared, rs.randint(0, 250, 11 + 4 * j).astype(np.int32)])
        for j in range(3)]                               # 31/35/39 toks
    prompts.append(rs.randint(0, 250, 26).astype(np.int32))  # disjoint
    prompts.append(rs.randint(0, 250, 6).astype(np.int32))   # short
    return prompts, [4, 3, 5, 4, 4]


def _drive(srv, prompts, lens, replay=2):
    """Serve the workload ``replay`` times, driving the engine inline
    (``_admit`` then ``_step_paged``, as its loop does) so both packages'
    engines see the same schedule."""
    out = []
    for _ in range(replay):
        reqs = [srv.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, lens)]
        while not all(r.done.is_set() for r in reqs):
            srv._admit()
            srv._step_paged()
        while srv._inflight:
            srv._drain_next()
        out.append([list(map(int, r.tokens)) for r in reqs])
    return out


def _counters(srv):
    return (srv.prefill_chunks_total, srv.prefill_tokens_total,
            srv.mixed_passes, srv.steps, srv._kv.hits, srv._kv.misses,
            srv.prefix_tokens_saved, srv._budget_avail, srv.pages_in_use)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("kvcache", [False, True])
def test_engine_matches_jax(pair, kvcache, mixed, depth):
    """Greedy tokens equal the JAX golden over two replays (the second
    hits the chains the first indexed); chunk, pass and cache counters
    and the ledger equal the JAX engine's; with the cache off the free
    list's page order too."""
    jm, tm = pair
    prompts, lens = _workload()
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE, mixed=mixed,
              chunk_tokens=CHUNK, kvcache=kvcache, pipeline_depth=depth)
    ref = JServer(jm, ragged_prefill=True, **kw)
    want = _drive(ref, prompts, lens)
    srv = LLMServer(tm, device="cpu", **kw)
    got = _drive(srv, prompts, lens)
    assert got == want == [_golden(jm, prompts, lens)] * 2
    assert _counters(srv) == _counters(ref)
    assert srv._budget_avail == srv._num_pages - 1 and srv.pages_in_use == 0
    assert (srv.prefill_chunks_total > 0) == mixed
    assert (srv.mixed_passes > 0) == mixed and (srv._kv.hits > 0) == kvcache
    if not kvcache:
        assert srv._free == ref._free
    ref.stop()
    srv.stop()


@pytest.mark.parametrize("kvcache", [False, True])
def test_dense_staging_prefill(pair, kvcache):
    """``ragged_prefill=False``: every prefill through
    ``paged_prefill_partial`` (the prefix gathered into a dense cache);
    mixed dispatch is inert there, as in the JAX engine. Tokens and
    counters equal the JAX engine's on its dense path."""
    jm, tm = pair
    prompts, lens = _workload()
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE, mixed=True,
              chunk_tokens=CHUNK, kvcache=kvcache, ragged_prefill=False)
    ref = JServer(jm, **kw)
    want = _drive(ref, prompts, lens)
    srv = LLMServer(tm, device="cpu", **kw)
    assert _drive(srv, prompts, lens) == want
    assert want[0] == _golden(jm, prompts, lens)
    assert _counters(srv) == _counters(ref)
    assert srv.prefill_chunks_total == 0
    ref.stop()
    srv.stop()


def test_cow_fork_across_chunks_with_live_decode_row(pair):
    """A chunked admission forks an indexed tail page at its first chunk
    while another request decodes on the same shared pages: both equal
    their goldens (``test_mixed_dispatch.py``'s, served threaded)."""
    jm, tm = pair
    rs = np.random.RandomState(5)
    P = rs.randint(0, 250, 20).astype(np.int32)        # 2.5 pages
    B = np.concatenate([P, rs.randint(0, 250, 18).astype(np.int32)])
    want_a, want_c, want_b = _golden(jm, [P, P, B], [4, 24, 4])
    srv = LLMServer(tm, max_batch=2, max_seq_len=64, page_size=PAGE,
                    mixed=True, chunk_tokens=CHUNK, kvcache=True,
                    pipeline_depth=2, device="cpu").start()
    try:
        assert srv.submit(P, max_new_tokens=4).get(timeout=600) == want_a
        rc = srv.submit(P, max_new_tokens=24)
        while len(rc.tokens) < 2 and not rc.done.is_set():
            time.sleep(0.001)
        rb = srv.submit(B, max_new_tokens=4)
        assert rb.get(timeout=600) == want_b
        assert rc.get(timeout=600) == want_c
        assert srv.prefill_chunks_total > 0 and srv._kv.hits >= 2
    finally:
        srv.stop()
    assert srv.errors == [] and srv._budget_avail == srv._num_pages - 1


@pytest.mark.parametrize("kvcache", [False, True])
def test_shed_during_chunking_rolls_back(pair, kvcache):
    """A chunked admission that cannot charge its next chunk within
    ``chunk_wait`` is shed: its request fails retriably, the budget goes
    back to what the decoding request holds, and a resubmission after
    the pressure clears equals the golden; at the end the ledger is
    whole and no page is held except by the index."""
    jm, tm = pair
    rs = np.random.RandomState(7)
    a_prompt = rs.randint(0, 250, 8).astype(np.int32)
    b_prompt = rs.randint(0, 250, 32).astype(np.int32)
    want_b = _golden(jm, [b_prompt], [8])[0]
    # 9 budget pages: A (8 + 40 new) charges 6, so B (5) admits its first
    # chunks but stalls at the decode top-up while A decodes
    srv = LLMServer(tm, max_batch=2, max_seq_len=64, page_size=PAGE,
                    num_pages=10, kvcache=kvcache, mixed=True,
                    chunk_tokens=CHUNK, chunk_wait=0.01, pipeline_depth=2,
                    device="cpu").start()
    try:
        ra = srv.submit(a_prompt, max_new_tokens=40)
        rb = srv.submit(b_prompt, max_new_tokens=8)
        with pytest.raises(RuntimeError, match="starved.*retriable"):
            rb.get(timeout=600)
        with srv._lock:
            if not ra.done.is_set():
                assert srv._budget_avail == 9 - 6
        assert len(ra.get(timeout=600)) == 40
        assert srv.submit(b_prompt, max_new_tokens=8).get(
            timeout=600) == want_b
    finally:
        srv.stop()
    st = srv._kv.debug_stats()
    assert srv._budget_avail == 9 and srv.pages_in_use == 0
    assert st["pages_pinned"] == 0
    assert st["pages_allocated"] == st.get("index", {}).get("nodes", 0)
