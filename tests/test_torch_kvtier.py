"""The port's host KV tier (``bigdl_tpu_torch/llm/kvtier``) and the engine
surface around it against the JAX package (tiny q4_0, f32 params and
KV, page 8, as ``tests/test_kvtier.py``): ``HostArena`` and ``Migrator``
driven by the same op sequence, handoff blobs byte for byte in both
directions, the eviction hammer (depths 1 and 2, ``mixed=``,
``priority=``'s "exported" preemption) driven inline beside the JAX
engine with both tiers' migrations inline (tokens, tier counters, page
ledger, warm chains), the async migration thread, a failed fetch,
export / import across engines and packages, ``abort``, the drain
surface and the refusals."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import reliability as rel
from bigdl_tpu.llm import kvtier as jtier
from bigdl_tpu.llm import serving as jserving
from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.utils.conf import conf

from bigdl_tpu_torch.llm import kvtier as ttier
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.kvtier.handoff import HandoffError
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer, OverloadError

PAGE = 8
TIER = dict(max_batch=2, max_seq_len=64, page_size=PAGE, num_pages=9,
            kvcache=True, kvtier=True, host_pages=32)


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


@pytest.fixture()
def sync_tier():
    """Inline migration in the JAX engine (the port's: ``kvtier_sync``)."""
    conf.set("bigdl.llm.kvtier.sync", "true")
    yield
    conf.unset("bigdl.llm.kvtier.sync")


def _servers(pair, **kw):
    jm, tm = pair
    kw = dict(TIER, **kw)
    return (jserving.LLMServer(jm, ragged_prefill=True, **kw),
            LLMServer(tm, device="cpu", kvtier_sync=True, **kw))


def _golden(jm, prompts, lens):
    return [list(map(int, jm.generate(p[None], max_new_tokens=n)[0, len(p):]))
            for p, n in zip(prompts, lens)]


def _hammer_workload(seed=17):
    """``test_kvtier.py``'s hammer: 4 groups of 16 shared tokens, two
    rounds of short tails; the pool holds about 2 of the 4 chains."""
    rs = np.random.RandomState(seed)
    groups = [rs.randint(0, 250, 16).astype(np.int32) for _ in range(4)]
    prompts = [np.concatenate([groups[g], rs.randint(
        0, 250, 2 + (g + rnd) % 3).astype(np.int32)])
        for rnd in range(2) for g in range(4)]
    return prompts, [int(rs.randint(2, 5)) for _ in prompts]


def _drive(srv, prompts, lens, one_by_one=True):
    """Serve the prompts driven inline (``_admit`` then ``_step``, the
    engine loop's pass): one at a time as the reference test's
    ``submit(...).get()``, or all submitted at once."""
    reqs = []
    for p, n in (zip(prompts, lens) if one_by_one else [(None, None)]):
        new = ([srv.submit(p, max_new_tokens=n)] if p is not None else
               [srv.submit(q, max_new_tokens=m)
                for q, m in zip(prompts, lens)])
        reqs += new
        while not all(r.done.is_set() for r in new):
            srv._admit()
            srv._step()
    while srv._inflight:
        srv._drain_next()
    return [list(map(int, r.tokens)) for r in reqs]


def _ledger(srv):
    st = srv._kv.debug_stats()
    return {k: st[k] for k in ("pages_pinned", "budget_avail", "pages_free",
                               "hits", "misses", "evictions",
                               "prefix_tokens_reused", "tier")}


# -- arena, migrator, handoff: the same op sequence on both packages ----------

def _page(ns, v):
    a = np.full((2, 1, PAGE, 4), v, np.float32)
    return a if ns is jtier else torch.from_numpy(a)


def _arena_ops(ns):
    """The cases of ``test_kvtier.py``'s arena tests as one sequence; the
    observable state after each step."""
    a, log = ns.HostArena(3, PAGE), []
    keys = [tuple(range(b, b + PAGE)) for b in (0, 100, 200, 300)]
    chain = tuple(range(2 * PAGE))
    s0 = a.reserve(keys[0])
    log.append((s0, a.lookup_chunks(range(PAGE + 4), 0, PAGE + 3)))
    a.commit(s0, _page(ns, 1.0), _page(ns, 2.0))
    s1 = a.reserve(chain)
    a.commit(s1, _page(ns, 3.0), _page(ns, 3.0))
    log.append(a.lookup_chunks(range(3 * PAGE), 0, 3 * PAGE - 1))
    k, v = a.read(s0)
    log.append((float(k[0, 0, 0, 0]), float(v[0, 0, 0, 0])))
    s2 = a.reserve(keys[1])
    a.commit(s2, _page(ns, 4.0), _page(ns, 4.0))
    a.lookup_chunks(range(PAGE), 0, PAGE)          # re-warm s0
    a.pin(s0)
    s3 = a.reserve(keys[2])                        # LRU skips the pin
    log.append((s3, a.host_evictions, a.read_keyed(s1, chain) is None))
    a.pin(s3)
    a.pin(s2 if s2 != s3 else s1)
    log.append(a.reserve(keys[3]))                 # all pinned: None
    a.abort(s3)
    log.append((a.used(), a.pinned(), a.stats(), sorted(a.keys())))
    with pytest.raises(ns.HostArenaError, match="full pages"):
        a.reserve(tuple(range(PAGE - 1)))
    return log


def test_arena_matches_jax():
    assert _arena_ops(ttier) == _arena_ops(jtier)


def _migrator_ops(ns):
    """Spill then fetch round trip, a failed spill, a failed fetch: slots,
    pins, stats and tallies (the port's failures by a patched
    transfer, the JAX package's by its fault sites)."""
    arena = ns.HostArena(4, PAGE)
    mig = ns.Migrator(arena, synchronous=True)
    dev = (jnp.asarray if ns is jtier else lambda x: x)
    key = tuple(range(PAGE))
    slot = arena.reserve(key)
    spill = ((key, slot, dev(_page(ns, 3.5)), dev(_page(ns, 4.5)))
             if ns is jtier else (key, slot, _page(ns, 3.5), _page(ns, 4.5)))
    ok = [mig.submit_spill(*spill).ok]
    arena.pin(slot)
    fj = mig.submit_fetch([(key, slot)])
    ok += [fj.ok, arena.pinned(), float(np.asarray(fj.k_dev[0]).max()),
           float(np.asarray(fj.v_dev[0]).min())]
    for kind in ("spill", "fetch"):
        if ns is jtier:
            plan = rel.FaultPlan(seed=0)
            plan.add(f"kvtier.{kind}", "raise", times=1)
            rel.set_plan(plan)
        else:
            def fail(job):
                raise RuntimeError("transfer failed")
            setattr(mig, f"_run_{kind}", fail)
        try:
            if kind == "spill":
                s = arena.reserve(tuple(range(50, 50 + PAGE)))
                job = mig.submit_spill(*spill[:1], s, *spill[2:])
            else:
                arena.pin(slot)
                job = mig.submit_fetch([(key, slot)])
        finally:
            rel.set_plan(None)
        ok.append(job.ok)
    return ok + [arena.stats(), mig.spills_done, mig.fetches_done,
                 mig.spill_failures, mig.fetch_failures]


def test_migrator_matches_jax():
    got = _migrator_ops(ttier)
    assert got == _migrator_ops(jtier)
    assert got[:2] == [True, True] and got[2] == 0 and got[-2:] == [1, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_handoff_blobs_byte_identical(dtype):
    """The same pages give the same bytes from both packages, and each
    package reads the other's blob bit for bit."""
    rs = np.random.RandomState(0)
    jdt = jnp.dtype(dtype)
    pages = [rs.randn(2, 1, PAGE, 4).astype(jdt) for _ in range(3)]

    def tp(a):
        t = torch.from_numpy(np.ascontiguousarray(a).view(
            np.uint16 if dtype == "bfloat16" else np.float32))
        return t.view(torch.bfloat16) if dtype == "bfloat16" else t

    toks = list(range(3 * PAGE + 2))
    jblob = jtier.serialize_chain(toks, pages, pages[::-1], PAGE)
    tblob = ttier.serialize_chain(toks, [tp(a) for a in pages],
                                  [tp(a) for a in pages[::-1]], PAGE)
    assert tblob == jblob
    t2, k2, v2, hdr = ttier.deserialize_chain(jblob)
    assert t2 == toks[:3 * PAGE] and hdr["dtype"] == dtype
    for a, b in zip(pages + pages[::-1], k2 + v2):
        assert torch.equal(tp(a), b)
    j2, jk, jv, _ = jtier.deserialize_chain(tblob)
    for a, b in zip(pages + pages[::-1], jk + jv):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("ns", [ttier, jtier])
def test_malformed_blobs_rejected(ns):
    with pytest.raises(ns.HandoffError, match="magic"):
        ns.deserialize_chain(b"nonsense")
    blob = ns.serialize_chain(list(range(PAGE)), [_page(ns, 0)],
                              [_page(ns, 0)], PAGE)
    with pytest.raises(ns.HandoffError, match="body holds"):
        ns.deserialize_chain(blob[:-8])


# -- the engine beside the JAX engine ----------------------------------------

@pytest.mark.parametrize("mode", ["depth 1", "depth 2", "mixed", "mixed all",
                                  "priority"])
def test_eviction_hammer_matches_jax(pair, sync_tier, mode):
    """A pool holding about 2 of 4 chains: pass 1 seeds and spills, pass 2
    re-adopts the evicted prefixes from the host arena. Tokens equal the
    JAX engine's and ``generate``'s; the tier's counters, the page ledger
    and the warm chains equal the JAX engine's, and come back whole.
    ``mixed``: chunked admissions bypass the tier (one page a chunk);
    ``priority``: interactive requests preempt batch decodes, whose
    chains are exported until they resume."""
    jm, _ = pair
    kw = {"depth 1": dict(pipeline_depth=1), "depth 2": {},
          "mixed": dict(mixed=True, chunk_tokens=PAGE),
          "mixed all": dict(mixed=True, chunk_tokens=PAGE),
          "priority": dict(priority=True, num_pages=12)}[mode]
    ref, srv = _servers(pair, **kw)
    if mode == "priority":
        rs = np.random.RandomState(11)
        batch = [rs.randint(0, 250, 10 + 3 * j).astype(np.int32)
                 for j in range(3)]
        inter = [rs.randint(0, 250, 6 + j).astype(np.int32)
                 for j in range(2)]
        prompts, lens = batch + inter, [12] * 3 + [4] * 2
        got, want = (_storm(s, batch, inter) for s in (srv, ref))
        assert srv.preempt_modes == {"dropped": 0, "indexed": 0,
                                     "exported": srv.preemptions_total}
        assert srv.preemptions_total == ref.preemptions_total >= 1
        assert srv.preempt_resumes_total == ref.preempt_resumes_total
        assert srv._parked == {} and srv.preempt_parked == 0
    else:
        prompts, lens = _hammer_workload()
        one = mode != "mixed all"
        got, want = (_drive(s, prompts, lens, one) for s in (srv, ref))
        assert (srv.prefill_chunks_total > 0) == mode.startswith("mixed")
        assert srv.prefill_chunks_total == ref.prefill_chunks_total
    assert got == want == _golden(jm, prompts, lens)
    st = _ledger(srv)
    assert st == _ledger(ref)
    assert st["tier"]["spills"] > 0 and st["tier"]["fetches"] > 0
    assert st["tier"]["fetch_failures"] == 0 and st["tier"]["pinned"] == 0
    assert st["pages_pinned"] == 0
    assert st["budget_avail"] == srv._num_pages - 1
    assert srv.warm_chains() == ref.warm_chains() != []
    assert srv.pages_in_use == 0 and srv.errors == [] and srv.fetch_waits
    ref.stop()
    srv.stop()


def _storm(srv, batch, inter, late=5):
    """Batch requests decoding, interactive ones after ``late`` passes."""
    rb = [srv.submit(p, 12, priority="batch") for p in batch]
    ri, n = None, 0
    while ri is None or not all(r.done.is_set() for r in rb + ri):
        srv._admit()
        if ri is None and n == late:
            ri = [srv.submit(p, 4, priority="interactive") for p in inter]
        srv._step_paged()
        n += 1
    while srv._inflight:
        srv._drain_next()
    return [list(map(int, r.tokens)) for r in rb + ri]


def test_async_migration_thread(pair):
    """The real migration thread: landing order races admission, and the
    tokens must not care."""
    jm, tm = pair
    prompts, lens = _hammer_workload(29)
    srv = LLMServer(tm, device="cpu", **TIER).start()
    try:
        got = [srv.submit(p, max_new_tokens=n).get(timeout=600)
               for p, n in zip(prompts, lens)]
        assert srv._tier.spills > 0
    finally:
        srv.stop()
    assert got == _golden(jm, prompts, lens) and srv.errors == []
    assert srv._tier.migrator._thread is None        # stop() joined it
    st = srv._kv.debug_stats()
    assert st["pages_pinned"] == 0 and st["tier"]["pinned"] == 0


def test_failed_fetch_degrades_to_miss(pair, sync_tier):
    """One failed transfer (the JAX package's fault site, the port's
    patched transfer): that admission prefills in full, the tokens are
    unchanged, one fetch failure, no pin left, the ledger whole."""
    jm, _ = pair
    prompts, lens = _hammer_workload(31)
    ref, srv = _servers(pair)

    def fail_once(job, real=srv._tier.migrator._run_fetch):
        srv._tier.migrator._run_fetch = real
        raise RuntimeError("transfer failed")

    srv._tier.migrator._run_fetch = fail_once
    plan = rel.FaultPlan(seed=0)
    plan.add("kvtier.fetch", "raise", times=1)
    rel.set_plan(plan)
    try:
        want = _drive(ref, prompts, lens)
    finally:
        rel.set_plan(None)
    got = _drive(srv, prompts, lens)
    assert got == want == _golden(jm, prompts, lens)
    st = _ledger(srv)
    assert st == _ledger(ref) and st["tier"]["fetch_failures"] == 1
    assert st["tier"]["pinned"] == st["pages_pinned"] == 0
    assert st["budget_avail"] == srv._num_pages - 1
    ref.stop()
    srv.stop()


def test_export_import_across_engines(pair, sync_tier):
    """Prefill on one port engine, export, import into another (and a JAX
    engine's blob into a third): each importer serves the prompt from its
    host tier with ``generate``'s tokens."""
    jm, tm = pair
    prompt = np.arange(1, 21, dtype=np.int32)          # 2 full pages
    want = _golden(jm, [prompt], [5])
    jsrv, a = _servers(pair)
    b, c = (LLMServer(tm, device="cpu", kvtier_sync=True, **TIER)
            for _ in range(2))
    for s in (a, jsrv):
        _drive(s, [prompt], [1])
    blob, jblob = a.export_chain(prompt), jsrv.export_chain(prompt)
    assert a._tier.handoffs_out == 1 and a._tier.handoff_bytes == len(blob)
    assert len(blob) == len(jblob)
    for dst, bl in ((b, blob), (c, jblob)):
        assert dst.import_chain(bl) == len(prompt) // PAGE
        assert _drive(dst, [prompt], [5]) == want
        assert dst._tier.fetches == 2 and dst._tier.handoffs_in == 1
        assert dst._kv.prefix_tokens_reused == 2 * PAGE
    for s in (jsrv, a, b, c):
        s.stop()


def test_abort_queued_parked_and_decoding(pair, sync_tier):
    """Abort one queued, one fetch-parked and one decoding request: the
    other row's tokens are unchanged and the page ledger equals the JAX
    engine's after the same aborts."""
    jm, _ = pair
    rs = np.random.RandomState(7)
    warm = [rs.randint(0, 250, 17).astype(np.int32) for _ in range(4)]
    hot = np.concatenate([warm[0][:16], [5]]).astype(np.int32)
    live, other, queued = (rs.randint(0, 250, n).astype(np.int32)
                           for n in (9, 5, 4))
    out = []
    for srv in _servers(pair):
        _drive(srv, warm, [3] * 4)            # warm[0]'s pages spilled
        rl, rh, ro, rq = (srv.submit(p, n) for p, n in (
            (live, 6), (hot, 4), (other, 3), (queued, 2)))
        srv._admit()
        assert srv._slots == [rl, ro] and len(srv._fetch_wait) == 1
        assert not srv.engine_idle()
        srv._step()
        for r in (rq, rh, rl):
            srv.abort(r)
        while not ro.done.is_set() or srv._inflight or \
                any(srv._slots) or srv._fetch_ready or srv._fetch_wait:
            srv._admit()
            srv._step()
        assert srv.engine_idle()
        out.append((ro.tokens, [r.error for r in (rl, rh, rq)],
                    _ledger(srv), srv.warm_chains()))
        srv.stop()
    assert out[0] == out[1]
    assert out[0][0] == _golden(jm, [other], [3])[0]
    assert all("aborted" in e for e in out[0][1])
    assert out[0][2]["pages_pinned"] == 0 and out[0][2]["budget_avail"] == 8


def test_drain_surface_matches_jax(pair):
    """``begin_drain`` sheds new submits with "server is draining" while
    the accepted one finishes, ``cancel_drain`` reopens, ``engine_idle``
    follows the work, in step with the JAX engine."""
    out = []
    for srv in _servers(pair, kvtier=False):
        r = srv.submit(np.arange(1, 7, dtype=np.int32), 3)
        log = [srv.engine_idle(), srv.draining]
        srv.begin_drain()
        with pytest.raises(Exception, match="draining") as shed:
            srv.submit(np.arange(1, 4, dtype=np.int32), 2)
        log += [srv.draining, srv.engine_idle()]
        while not r.done.is_set():
            srv._admit()
            srv._step()
        while srv._inflight:
            srv._drain_next()
        log.append(srv.engine_idle())
        srv.cancel_drain()
        srv.submit(np.arange(1, 4, dtype=np.int32), 2)
        log += [srv.draining, srv.engine_idle(), srv.warm_chains()]
        out.append((log, type(shed.value).__name__))
        srv.stop()
    assert out[0][0] == out[1][0]
    assert out[0][0][:5] == [False, False, True, False, True]
    assert out[0][1] == OverloadError.__name__


def test_refusals_match_jax(pair, sync_tier):
    """The tier without the prefix cache (the JAX message), a handoff
    without the tier, and a blob of another geometry."""
    jm, tm = pair
    with pytest.raises(ValueError) as want:
        jserving.LLMServer(jm, max_batch=2, max_seq_len=32, page_size=PAGE,
                           kvtier=True)
    with pytest.raises(ValueError) as got:
        LLMServer(tm, max_batch=2, max_seq_len=32, kvtier=True, device="cpu")
    assert str(got.value) == str(want.value)
    srv = LLMServer(tm, max_batch=2, max_seq_len=32, kvcache=True,
                    device="cpu")
    assert srv._tier is None and "tier" not in srv._kv.debug_stats()
    with pytest.raises(RuntimeError, match="kvtier"):
        srv.export_chain(np.arange(8, dtype=np.int32))
    with pytest.raises(RuntimeError, match="kvtier"):
        srv.import_chain(b"BDKV1\n")
    srv = LLMServer(tm, device="cpu", kvtier_sync=True, **TIER)
    blob = ttier.serialize_chain(
        list(range(16)), [torch.zeros(1, 1, 16, 2)],
        [torch.zeros(1, 1, 16, 2)], 16)
    with pytest.raises(HandoffError, match="do not fit"):
        srv.import_chain(blob)
    srv.stop()
