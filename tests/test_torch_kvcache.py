"""The port's prefix cache (``bigdl_tpu_torch/llm/kvcache``) against the
JAX package's: ``PagePool``, ``RadixIndex`` and ``KVCacheManager`` run
the same scenarios and the same seeded random sequences of admit,
chunk charge, cancel, release, insert, lookup and evict, and must give
the same matches, admissions, evicted ids, refcounts, pins, free lists
and budget after every step; then the engine's LRU-eviction hammer
against the JAX ``generate`` golden (tiny q4_0, f32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.llm.kvcache as jkv
from bigdl_tpu.llm.models import llama as jllama

import bigdl_tpu_torch.llm.kvcache as tkv
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import LLMServer

PAGE = 8


def _state(kv):
    """Everything observable of a manager's pool and index."""
    p = kv.pool
    idx = kv.index.stats() if kv.index is not None else None
    return (p.budget_avail, list(p.free_ids()), sorted(p._ref.items()),
            sorted(p._pins.items()), kv.hits, kv.misses, kv.evictions,
            kv.prefix_tokens_reused, idx)


def _fields(x):
    """A ``PrefixMatch``'s or an ``Admission``'s fields."""
    if x is None:
        return None
    keys = ("matched_len", "shared_pages" if hasattr(x, "charge")
            else "full_pages", "tail_src", "tail_len")
    return tuple(list(getattr(x, k)) if k.endswith("pages")
                 else getattr(x, k) for k in keys) + (
        (x.charge,) if hasattr(x, "charge") else ())


# -- scenarios of tests/test_kvcache.py, run on both packages -----------------

def _pool_order(ns):
    pool = ns.PagePool(6, PAGE)
    out = [pool.take_free() for _ in range(5)]
    pool.decref(3)
    pool.decref(1)
    out += [pool.take_free(), pool.take_free()]
    with pytest.raises(ns.PagePoolError):
        pool.take_free()
    pool.decref(5)
    return out + [list(pool.free_ids())]


def _pool_refcounts(ns):
    pool = ns.PagePool(4, PAGE)
    p = pool.take_free()
    pool.incref(p)
    out = [pool.decref(p), pool.free_pages(), pool.decref(p),
           pool.free_pages()]
    with pytest.raises(ns.PagePoolError):
        pool.decref(p)
    return out


def _pool_pins(ns):
    pool = ns.PagePool(6, PAGE)
    pool.charge(2)
    p = pool.take_free()
    out = [pool.pin_cost([p, p])]
    for op in (pool.pin, pool.pin, pool.unpin, pool.unpin):
        op(p)
        out.append(pool.budget_avail)
    pool.pin_precharged(p)
    pool.charge(1)
    pool.pin_precharged(p)                 # surplus pre-charge returned
    out += [pool.budget_avail, pool.pinned_pages(), pool.evictable(p)]
    with pytest.raises(ns.PagePoolError):
        pool.charge(10)
    return out


def _radix(ns):
    pool = ns.PagePool(16, 4)
    idx = ns.RadixIndex(pool)
    pages = pool.alloc(3)
    idx.insert(list(range(10)), pages)
    out = [_fields(idx.lookup(t)) for t in (
        list(range(10)), [0, 1, 2, 3, 4, 5, 99, 99], [7, 7, 7, 7])]
    dup = pool.alloc(2)
    out += [idx.insert(list(range(8)), dup), pool.refcount(dup[0]),
            idx.token_path(idx._nodes[-1]), idx.leaf_paths(), idx.stats()]
    return out


def _radix_lru(ns):
    pool = ns.PagePool(8, 4)
    idx = ns.RadixIndex(pool)
    cold, warm = pool.alloc(2), pool.alloc(2)
    idx.insert([1, 1, 1, 1, 2, 2, 2, 2], cold)
    idx.insert([3, 3, 3, 3, 4, 4, 4, 4], warm)
    for p in cold + warm[:1]:
        pool.decref(p)            # warm[1] stays adopted by a request
    idx.lookup([1, 1, 1, 1])
    return [idx.evict_lru(1), idx.evict_lru(5), pool.refcount(warm[1]),
            [n.page for n in idx._nodes], pool.free_pages()]


def _manager(ns):
    out = []
    kv = ns.KVCacheManager(9, PAGE, enabled=False)
    adm = kv.admit(np.arange(10), 6)
    out += [kv.index is None, _fields(adm), kv.budget_avail,
            kv.admit(np.arange(10), 6, chunk_pages=1).charge]
    kv = ns.KVCacheManager(17, PAGE, enabled=True)
    toks = list(range(20))
    pages = kv.alloc(3)
    kv.insert(toks, pages)
    kv.free_owned(pages)
    adm = kv.admit(toks + [77, 78], 10)          # shared 2 pages + a tail
    out += [_fields(adm), kv.budget_avail]
    kv.release_transient(adm)
    out.append(kv.budget_avail)
    kv.cancel(adm)
    adm = kv.admit(list(range(16)), 4)           # fully cached full pages
    out += [_fields(adm), kv.peek(list(range(16)), 4)]
    kv.cancel(adm)
    return out + [_state(kv)]


@pytest.mark.parametrize("scenario", [_pool_order, _pool_refcounts,
                                      _pool_pins, _radix, _radix_lru,
                                      _manager])
def test_scenario_matches_jax(scenario):
    assert scenario(tkv) == scenario(jkv)


def test_scenario_values():
    """A few of the reference tests' own expectations, on the port."""
    assert _pool_order(tkv)[:7] == [1, 2, 3, 4, 5, 1, 3]
    m = _radix(tkv)
    assert m[0][:2] == (10, m[0][1]) and m[0][3] == 2
    assert m[1][0] == 6 and m[1][3] == 2 and m[2][0] == 0
    assert m[3] == [] and m[4] == 1           # duplicates not adopted
    lru = _radix_lru(tkv)
    # leaf-first: the adopted warm[1] and its parent are never victims
    assert len(lru[0]) == 1 and len(lru[1]) == 1 and lru[2] == 2
    mgr = _manager(tkv)
    assert mgr[1][4] == 2 and mgr[4][4] == 2 and mgr[5] == 16 - 2 - 3
    assert mgr[7][0] == 15 and mgr[7][3] == PAGE - 1   # >= 1 suffix token
    # evict_lru(spill=) offers each victim's token path and page to the
    # host tier before its ref drops, leaf first, as the JAX index does
    seen = []
    for ns in (tkv, jkv):
        pool = ns.PagePool(4, 4)
        idx = ns.RadixIndex(pool)
        pages = pool.alloc(2)
        idx.insert(list(range(8)), pages)
        for pid in pages:
            pool.decref(pid)
        calls = []
        freed = idx.evict_lru(2, spill=lambda path, pid: calls.append(
            (tuple(path), pid, pool.refcount(pid))))
        seen.append((freed, calls))
    assert seen[0] == seen[1]
    assert seen[0][1] == [(tuple(range(8)), pages[1], 1),
                          (tuple(range(4)), pages[0], 1)]


def _random_sequence(ns, seed):
    """An engine-like sequence: admissions (some chunked) that allocate
    their pages and index the full prompt pages, chunk charges, cancels,
    finishes that index prompt + output and release, lookups and
    evictions; the state logged after every step."""
    rs = np.random.RandomState(seed)
    kv = ns.KVCacheManager(16, 4, enabled=True)
    bases = [list(rs.randint(0, 6, 12)) for _ in range(3)]
    live, log = [], []
    for _ in range(80):
        op = rs.randint(7)
        prompt = bases[rs.randint(3)][:rs.randint(1, 13)] + list(
            rs.randint(0, 6, rs.randint(0, 5)))
        try:
            if op <= 1:
                T, new = len(prompt), int(rs.randint(1, 6))
                chunk = int(rs.randint(1, 3)) if op == 1 else None
                adm = kv.admit(prompt, new, chunk_pages=chunk)
                log.append(_fields(adm))
                if adm is not None:
                    koff = adm.matched_len // 4
                    n = chunk if chunk else kv.suffix_budget(
                        T, new, adm.matched_len)
                    kv.ensure_free(n)
                    own = kv.alloc(n)
                    kv.release_transient(adm)
                    rows = list(adm.shared_pages) + own
                    nfull = min(T // 4, len(rows))
                    kv.insert(prompt[:nfull * 4], rows[:nfull])
                    live.append((adm, own, rows, prompt, koff))
            elif op == 2 and live:
                adm = live[rs.randint(len(live))][0]
                log.append(kv.charge_chunk(adm, int(rs.randint(0, 4))))
            elif op == 3 and live:
                adm, own = live.pop(rs.randint(len(live)))[:2]
                kv.free_owned(own)
                kv.cancel(adm)
            elif op == 4 and live:
                adm, own, rows, prompt = live.pop(rs.randint(len(live)))[:4]
                toks = (prompt + list(rs.randint(0, 6, 3)))[:len(rows) * 4]
                kv.insert(toks, rows)
                kv.release_slot(adm.charge, own, adm.shared_pages)
            elif op == 5:
                log.append(_fields(kv.index.lookup(prompt)))
            else:
                kv.ensure_free(int(rs.randint(1, 8)))
        except ns.PagePoolError as e:
            log.append(("PagePoolError", str(e)))
        log.append(_state(kv))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_sequence_matches_jax(seed):
    got, want = _random_sequence(tkv, seed), _random_sequence(jkv, seed)
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {j}"


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


@pytest.mark.parametrize("depth", [1, 2])
def test_lru_eviction_hammer(pair, depth):
    """A pool too small to keep every chain warm: admission and decode
    evict mid-stream, every request's tokens equal the JAX golden, and
    the ledger is whole afterwards (the port of
    ``test_kvcache.py::test_lru_eviction_hammer_mid_stream``)."""
    jm, tm = pair
    rs = np.random.RandomState(23)
    shared = rs.randint(0, 250, 12).astype(np.int32)
    prompts = []
    for j in range(10):
        tail = rs.randint(0, 250, rs.randint(1, 14)).astype(np.int32)
        base = shared if j % 2 == 0 else \
            rs.randint(0, 250, 12).astype(np.int32)
        prompts.append(np.concatenate([base, tail]))
    lens = [int(rs.randint(1, 6)) for _ in prompts]
    want = [jm.generate(p[None], max_new_tokens=n)[0, len(p):].tolist()
            for p, n in zip(prompts, lens)]
    srv = LLMServer(tm, max_batch=2, max_seq_len=64, page_size=PAGE,
                    num_pages=11, kvcache=True, pipeline_depth=depth,
                    device="cpu").start()
    try:
        got = [r.get(timeout=600) for r in
               [srv.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, lens)]]
    finally:
        srv.stop()
    assert got == want and srv.errors == []
    assert srv._kv.evictions > 0 and srv._kv.hits > 0
    st = srv._kv.debug_stats()
    assert st["pages_pinned"] == 0 and st["budget_avail"] == 10
    assert st["pages_allocated"] == st["index"]["nodes"]
    assert srv.pages_in_use == 0
