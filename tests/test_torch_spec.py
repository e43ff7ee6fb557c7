"""The port's self-speculative decoding against the JAX package (tiny
q4_0, f32 params and KV, page 8): ``NGramProposer`` step for step,
``spec_accept`` on seeded logits with ties, ``paged_step_spec`` against
``make_spec_step`` at offsets that cross a page, and the engine with
``spec=True`` driven inline beside the JAX engine: tokens equal to the
JAX engine's and to both packages' ``generate``, and every speculation
counter and ``steps`` equal, over kvcache x depth, with mixed dispatch
and chunked admission, and on a workload with nothing to draft."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.kernels.sampling import spec_accept as j_accept
from bigdl_tpu.llm.kvcache.prefill import make_spec_step as j_spec
from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.llm.serving import LLMServer as JServer
from bigdl_tpu.llm.serving import paged_decode_step as j_decode
from bigdl_tpu.llm.spec import NGramProposer as JProposer

from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.kernels.sampling import spec_accept
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer
from bigdl_tpu_torch.llm.spec import NGramProposer

PAGE = 8


@pytest.fixture(scope="module")
def pair():
    cfg = jllama.LlamaConfig.tiny()
    p = jllama.quantize_params(jllama.init_params(cfg, 0, dtype=jnp.float32),
                               "sym_int4")
    jm = jllama.LlamaForCausalLM(cfg, p, max_cache_len=256,
                                 cache_dtype=jnp.float32)
    tm = tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
        max_cache_len=256, cache_dtype=torch.float32, page_size=PAGE,
        device="cpu")
    return jm, tm


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 8), (2, 3)])
def test_proposer_matches_jax(seed, k):
    """Over a seeded history on a small vocabulary (so n-grams recur),
    grown a token at a time with seeded verify outcomes: the same
    proposals, ``k_live``, ``acc_ema``, ``last_match`` and totals."""
    rs = np.random.RandomState(seed)
    ids = list(rs.randint(0, 6, 12))
    ours, ref = NGramProposer(k=k), JProposer(k=k)
    for step in range(60):
        limit = None if step % 3 else int(rs.randint(1, 10))
        got, want = ours.propose(ids, limit), ref.propose(ids, limit)
        assert got == want
        if len(got) > 1:
            acc = int(rs.randint(0, len(got)))
            ours.observe(len(got) - 1, acc)
            ref.observe(len(want) - 1, acc)
        for a in ("k_live", "acc_ema", "last_match", "proposed_total",
                  "accepted_total", "accept_rate"):
            assert getattr(ours, a) == getattr(ref, a), (step, a)
        ids.append(int(rs.randint(0, 6)) if rs.rand() < 0.5 else
                   (got or [0])[0])


@pytest.mark.parametrize("w", [2, 4, 8])
def test_spec_accept_matches_jax(w):
    """Seeded logits on a 12-token vocabulary rounded to halves (so rows
    tie and the first maximum must win, as in ``jnp.argmax``), chunks
    whose drafts follow the greedy tokens for a seeded prefix, and every
    ``n_draft`` from 0 to W - 1: the same ``n_acc`` and last row."""
    rs = np.random.RandomState(w)
    for trial in range(9):
        logits = (np.round(rs.randn(w, 12) * 2) / 2).astype(np.float32)
        logits[:, 11] = logits[:, :11].max(-1)   # every row ties at its max
        greedy = logits.argmax(-1)
        assert (greedy < 11).all()
        ctoks = rs.randint(0, 12, w).astype(np.int32)
        keep = rs.randint(0, w)
        ctoks[1:1 + keep] = greedy[:keep]
        if trial % 3 == 0:
            ctoks[1:1 + keep] = 11           # the tie's other index: no match
        for nd in range(w):
            n, last = spec_accept(torch.from_numpy(ctoks),
                                  torch.from_numpy(logits), nd)
            jn, jlast = j_accept(jnp.asarray(ctoks), jnp.asarray(logits),
                                 jnp.int32(nd))
            assert int(n) == int(jn) and n.dtype == torch.int32
            np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


@pytest.mark.parametrize("off,nd,bucket", [(9, 3, 4), (14, 5, 8),
                                           (16, 1, 2), (20, 7, 8)])
def test_spec_step_matches_jax(pair, off, nd, bucket):
    """One verify step on the same pools and operands: row 2's drafts at
    offset ``off`` (crossing a page boundary for most offsets) beside
    two decode rows and an empty slot. Output ids (decode ids, ``n_acc``,
    chunk tokens) and lengths equal; logits and every real page within
    1e-5."""
    jm, tm = pair
    cfg = tm.config
    rs = np.random.RandomState(off)
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    kp, vp = (rs.randn(L, 14, Hkv, PAGE, D).astype(np.float32)
              for _ in range(2))
    bt = np.array([[1, 2, 0, 0], [4, 5, 0, 0], [9, 10, 11, 12],
                   [0] * 4], np.int32)
    lens = np.array([9, 15, off, 0], np.int32)
    last = rs.randn(4, cfg.vocab_size).astype(np.float32)
    active = np.array([True, True, False, False])
    ctoks = np.zeros((1, bucket), np.int32)
    # drafts that repeat row 2's greedy token, so some are accepted
    ctoks[0, 1:1 + nd] = last[2].argmax()
    pos = off + np.arange(bucket)
    cphys = np.where(pos < off + nd + 1, bt[2][np.minimum(pos // PAGE, 3)],
                     0).astype(np.int32)
    cslots = (pos % PAGE).astype(np.int32)
    args = (bt, lens, last, active)
    spec = (2, ctoks, nd, bt[2], cphys, cslots)
    out, wl, wk, wv, wlen, _ = j_spec(j_decode, jllama.paged_prefill_ragged)(
        jm.params, jm.config, jnp.asarray(kp), jnp.asarray(vp),
        *map(jnp.asarray, args), 1.0, jax.random.PRNGKey(0),
        *(jnp.asarray(a, jnp.int32) for a in spec), page=PAGE)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    got, gl, gk, gv, glen = tllama.paged_step_spec(
        tm.params, cfg, tk, tv, *map(t, args), 1.0, None,
        *(t(np.asarray(a, np.int32)) for a in spec), page=PAGE)
    assert gk is tk and gv is tv                       # in place
    # the JAX output ends in a fence element, which the port has not
    np.testing.assert_array_equal(got.numpy(), np.asarray(out)[:-1])
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    for g, w in ((gl, wl), (gk[:, 1:], np.asarray(wk)[:, 1:]),
                 (gv[:, 1:], np.asarray(wv)[:, 1:])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def _workload():
    """``tests/test_spec_decode.py``'s: a prompt whose greedy
    continuation falls into a short cycle, and a short plain one."""
    rs = np.random.RandomState(42)
    pattern = rs.randint(0, 250, 5).astype(np.int32)
    return [np.tile(pattern, 6).astype(np.int32),
            rs.randint(0, 250, 7).astype(np.int32)], [24, 6]


def _drive(srv, prompts, lens):
    """Serve inline (``_admit`` then ``_step_paged``, the engine loop's
    pass), so both packages' engines see the same schedule."""
    reqs = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, lens)]
    while not all(r.done.is_set() for r in reqs):
        srv._admit()
        srv._step_paged()
    while srv._inflight:
        srv._drain_next()
    return [list(map(int, r.tokens)) for r in reqs]


def _counters(srv):
    return (srv.spec_passes, srv.spec_proposed_total,
            srv.spec_accepted_total, srv.spec_emitted_total, srv.steps,
            srv.prefill_chunks_total, srv._budget_avail)


def _golden(jm, tm, prompts, lens):
    want = [list(map(int, jm.generate(p[None], max_new_tokens=n)[0, len(p):]))
            for p, n in zip(prompts, lens)]
    assert want == [tm.generate(p[None], max_new_tokens=n)[0, len(p):]
                    .tolist() for p, n in zip(prompts, lens)]
    return want


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("kvcache", [False, True])
def test_engine_matches_jax(pair, kvcache, depth):
    """``spec=True, spec_k=8``: tokens equal to the JAX engine's and to
    ``generate``; passes, proposed / accepted / emitted and steps equal
    the JAX engine's; every pass emits ``g0`` plus its accepted drafts;
    drafts were accepted; the ledger and the pool come back whole."""
    jm, tm = pair
    prompts, lens = _workload()
    kw = dict(max_batch=2, max_seq_len=128, page_size=PAGE, spec=True,
              spec_k=8, kvcache=kvcache, pipeline_depth=depth)
    ref = JServer(jm, ragged_prefill=True, **kw)
    srv = LLMServer(tm, device="cpu", **kw)
    assert _drive(srv, prompts, lens) == _drive(ref, prompts, lens) == \
        _golden(jm, tm, prompts, lens)
    assert _counters(srv) == _counters(ref)
    assert srv.spec_emitted_total == \
        srv.spec_passes + srv.spec_accepted_total
    assert srv.spec_accepted_total > 0
    assert srv.spec_accepted_total <= srv.spec_proposed_total
    assert srv._budget_avail == srv._num_pages - 1 and srv.pages_in_use == 0
    assert not srv._spec_pending and srv.errors == []
    ref.stop()
    srv.stop()


@pytest.mark.parametrize("depth", [1, 2])
def test_spec_with_mixed_chunked_admission(pair, depth):
    """A spec row beside a chunked admission sharing its radix prefix
    (``test_spec_decode.py``'s): chunk passes, COW adoption and verify
    passes over the same pages; tokens and counters equal the JAX
    engine's, and chunks and verifies both ran."""
    jm, tm = pair
    prompts, lens = _workload()
    rs = np.random.RandomState(7)
    prompts.append(np.concatenate(
        [prompts[0], rs.randint(0, 250, 17).astype(np.int32)]))
    lens.append(4)
    kw = dict(max_batch=2, max_seq_len=128, page_size=PAGE, spec=True,
              spec_k=8, kvcache=True, mixed=True, chunk_tokens=PAGE,
              num_pages=64, pipeline_depth=depth)
    ref = JServer(jm, ragged_prefill=True, **kw)
    srv = LLMServer(tm, device="cpu", **kw)
    assert _drive(srv, prompts, lens) == _drive(ref, prompts, lens) == \
        _golden(jm, tm, prompts, lens)
    assert _counters(srv) == _counters(ref)
    assert srv.spec_passes > 0 and srv.prefill_chunks_total > 0
    ref.stop()
    srv.stop()


def test_zero_match_degrades_to_plain_decode(pair):
    """A workload with little to draft: spec-on tokens equal spec-off
    and the JAX engine's, with the JAX engine's pass counts."""
    jm, tm = pair
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 250, 9).astype(np.int32),
               rs.randint(0, 250, 11).astype(np.int32)]
    lens = [6, 5]
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE, spec_k=8,
              pipeline_depth=2)
    off = _drive(LLMServer(tm, device="cpu", **kw), prompts, lens)
    ref = JServer(jm, ragged_prefill=True, spec=True, **kw)
    srv = LLMServer(tm, device="cpu", spec=True, **kw)
    assert _drive(srv, prompts, lens) == off == _drive(ref, prompts, lens)
    assert _counters(srv) == _counters(ref)
    assert srv.spec_emitted_total == \
        srv.spec_passes + srv.spec_accepted_total


def test_spec_rules(pair):
    """Spec is greedy-only (``temperature > 0`` raises, as in the JAX
    engine); off, it leaves no proposer state; on the dense staging
    path it is inert."""
    _, tm = pair
    with pytest.raises(ValueError, match="greedy"):
        LLMServer(tm, spec=True, temperature=0.7, device="cpu")
    assert LLMServer(tm, device="cpu")._spec_state is None
    assert not LLMServer(tm, spec=True, ragged_prefill=False,
                         device="cpu")._spec_active
    srv = LLMServer(tm, spec=True, spec_k=8, device="cpu")
    assert srv._spec_active and srv._spec_wmax == 8
    assert srv._toks_host[0].shape == (srv.max_batch + 1 + 8,)
