"""The port's priority classes and lossless preemption against the JAX
package (tiny q4_0, f32 params and KV, page 8): the class model and the
scheduler's order (``tests/test_priority.py``'s units), a backlog served
in class order, preempt and resume driven inline beside the JAX engine
(the victims' tokens equal to their unpreempted run and to the JAX
engine's, with its preemption and resume counts) over depth x kvcache,
the hold rule, and ``priority=False`` building no scheduler."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm import serving as jserving
from bigdl_tpu.llm.models import llama as jllama

from bigdl_tpu_torch.llm import serving
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import (CLASS_RETRY_WEIGHTS,
                                         PRIORITY_CLASSES, LLMServer,
                                         OverloadError, _PriorityScheduler,
                                         normalize_priority)

PAGE = 8


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


class _Stub:
    """A request stand-in: the scheduler reads ``priority``, ``done``
    and ``resume_ids``."""

    def __init__(self, priority, resumed=False):
        self.priority = priority
        self.done = threading.Event()
        self.resume_ids = np.zeros(1, np.int32) if resumed else None


@pytest.mark.parametrize("value", [None, "interactive", "  BATCH ",
                                   "Standard", "p99-or-bust", 7])
def test_normalize_priority_matches_jax(value):
    assert normalize_priority(value) == jserving.normalize_priority(value)
    assert normalize_priority(value) in PRIORITY_CLASSES


def test_class_model_matches_jax():
    assert PRIORITY_CLASSES == jserving.PRIORITY_CLASSES
    assert CLASS_RETRY_WEIGHTS == jserving.CLASS_RETRY_WEIGHTS
    assert serving._PRIORITY_RANK == jserving._PRIORITY_RANK


@pytest.mark.parametrize("sched_cls", [_PriorityScheduler,
                                       jserving._PriorityScheduler])
def test_scheduler_order(sched_cls):
    """Class order, FIFO within a class, a re-parked head back in front,
    and the live / depth / parked views, in both packages' schedulers."""
    sched = sched_cls()
    b1, i1, s1, i2 = (_Stub("batch"), _Stub("interactive"),
                      _Stub("standard"), _Stub("interactive"))
    for r in (b1, i1, s1, i2):
        sched.push(r)
    head = sched.pop_entry()
    sched.push_entry(head)                 # a budget-blocked head
    order = []
    while len(sched):
        order.append(sched.pop_entry()[2])
    assert order == [i1, i2, s1, b1]
    for r in (_Stub("interactive"), _Stub("batch"),
              _Stub("batch", resumed=True)):
        sched.push(r)
    gone = _Stub("standard")
    gone.done.set()
    sched.push(gone)
    assert sched.depths() == {"interactive": 1, "standard": 0, "batch": 2}
    assert (sched.parked(), sched.live(), sched.best_rank()) == (1, 3, 0)


def _golden(jm, prompts, lens):
    return [list(map(int, jm.generate(p[None], max_new_tokens=n)[0, len(p):]))
            for p, n in zip(prompts, lens)]


def test_backlog_served_in_class_order(pair):
    """One slot busy with an interactive request; a batch, a standard and
    an interactive request queue behind it in that order: they are
    served interactive, standard, batch (no preemption: the occupant's
    class is the best), each with its golden tokens."""
    jm, tm = pair
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 250, 6 + j).astype(np.int32) for j in range(4)]
    lens = [8, 2, 2, 2]
    srv = LLMServer(tm, max_batch=1, max_seq_len=64, num_pages=12,
                    kvcache=True, priority=True, device="cpu")
    reqs = [srv.submit(prompts[0], lens[0], priority="interactive")]
    srv._admit()
    srv._step_paged()
    reqs += [srv.submit(p, n, priority=c) for p, n, c in zip(
        prompts[1:], lens[1:], ("batch", None, "interactive"))]
    assert srv.retry_depth("batch") == 4 * srv.retry_depth("interactive") \
        == 2 * srv.retry_depth() == 6
    while not all(r.done.is_set() for r in reqs):
        srv._admit()
        srv._step_paged()
    firsts = [r.t_first_token for r in reqs]
    assert firsts[0] < firsts[3] < firsts[2] < firsts[1]
    assert [r.tokens for r in reqs] == _golden(jm, prompts, lens)
    assert srv.preemptions_total == 0
    assert srv.class_depths() == {c: 0 for c in PRIORITY_CLASSES}


def _storm(srv, batch, inter, late, n_batch=12, n_inter=4):
    """Batch requests decoding; after ``late`` passes the interactive
    ones arrive. Driven inline, as the engine loop's pass."""
    rb = [srv.submit(p, n_batch, priority="batch") for p in batch]
    ri, n = None, 0
    while ri is None or not all(r.done.is_set() for r in rb + ri):
        srv._admit()
        if ri is None and n == late:
            ri = [srv.submit(p, n_inter, priority="interactive")
                  for p in inter]
        srv._step_paged()
        n += 1
    while srv._inflight:
        srv._drain_next()
    return [list(map(int, r.tokens)) for r in rb + ri], rb


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("kvcache", [False, True])
def test_preempt_resume_matches_jax(pair, kvcache, depth):
    """Three batch requests over two slots, then two interactive ones:
    batch decodes are preempted and resume (re-prefilling prompt +
    generated, or adopting their indexed chain with the cache). Every
    request's tokens equal its unpreempted ``generate`` and the JAX
    engine's, the preemption and resume counts equal the JAX engine's,
    and the ledger comes back whole."""
    jm, tm = pair
    rs = np.random.RandomState(11)
    batch = [rs.randint(0, 250, 10 + 3 * j).astype(np.int32)
             for j in range(3)]
    inter = [rs.randint(0, 250, 6 + j).astype(np.int32) for j in range(2)]
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE, num_pages=12,
              priority=True, kvcache=kvcache, pipeline_depth=depth)
    ref = jserving.LLMServer(jm, ragged_prefill=True, **kw)
    want, jrb = _storm(ref, batch, inter, 5)
    srv = LLMServer(tm, device="cpu", **kw)
    got, rb = _storm(srv, batch, inter, 5)
    assert got == want == _golden(jm, batch + inter, [12] * 3 + [4] * 2)
    assert (srv.preemptions_total, srv.preempt_resumes_total) == \
        (ref.preemptions_total, ref.preempt_resumes_total)
    assert srv.preemptions_total >= 1
    assert srv.preempt_resumes_total == srv.preemptions_total
    assert [r.preemptions for r in rb] == [r.preemptions for r in jrb]
    assert srv.preempt_parked == 0 and srv._budget_avail == 11
    assert srv.pages_in_use == 0 and srv.errors == []
    ref.stop()
    srv.stop()


@pytest.mark.parametrize("depth,delay", [(3, 2), (4, 2), (4, 3)])
def test_hold_keeps_victim_out_of_its_slot(pair, depth, delay):
    """Slot 0 free but the waiter budget-blocked; the victim (slot 2) is
    preempted, the waiter takes slot 0, and a neighbour (slot 3) whose
    last step is already in flight finishes before the victim's hold
    record drains: slot 2 and the budget are free while the victim is
    held, and it stays out of every slot until the record drains, then
    resumes in slot 2 with its golden tokens. A copy of the engine whose
    hold is cut takes the record's stale token there instead."""
    jm, tm = pair
    rs = np.random.RandomState(5)
    x, a, b, y, w = (rs.randint(0, 250, n).astype(np.int32)
                     for n in (5, 10, 13, 6, 7))
    want = _golden(jm, [a, b, y, w], [30, 30, 6, 4])

    def run(cut_hold):
        # budget 14: x 1 page, a 5, b 6, y 2; the waiter needs 2
        srv = LLMServer(tm, max_batch=4, max_seq_len=64, num_pages=15,
                        priority=True, pipeline_depth=depth, device="cpu")
        if cut_hold:
            srv._sched_pop = srv._sched.pop_entry
        reqs = [srv.submit(p, n, "batch")
                for p, n in ((x, 1), (a, 30), (b, 30), (y, 6))]
        rx, ra, rb, ry = reqs
        srv._admit()                            # slots 0..3
        rw, spent, held_free, resumed_in = None, 0, 0, None
        while rw is None or not all(r.done.is_set() for r in reqs + [rw]):
            if rw is None and srv._remaining[3] == 0 and \
                    not ry.done.is_set():
                spent += 1
                if spent == delay:
                    rw = srv.submit(w, 4, "interactive")
            srv._admit()
            rec = rb._hold_rec
            if not cut_hold and rec is not None and \
                    any(r is rec for r in srv._inflight):
                assert rb not in srv._slots
                held_free += srv._slots[2] is None and ry.done.is_set()
            if rb in srv._slots and resumed_in is None and rb.preemptions:
                resumed_in = srv._slots.index(rb)
            srv._step_paged()
        while srv._inflight:
            srv._drain_next()
        assert srv.preemptions_total == 1 and rb.preemptions == 1
        return [ra.tokens, rb.tokens, ry.tokens, rw.tokens], held_free, \
            resumed_in

    got, held_free, resumed_in = run(False)
    assert got == want and held_free > 0 and resumed_in == 2
    assert run(True)[0][1] != want[1]


def test_priority_off_builds_no_scheduler(pair):
    """``priority=False``: no scheduler, no class surfaces, a class hint
    is plain metadata and Retry-After depth is unweighted; with it, the
    intake bound covers the queue and the heap together."""
    _, tm = pair
    srv = LLMServer(tm, max_batch=1, max_seq_len=64, device="cpu")
    assert srv._sched is None and srv.class_depths() is None
    assert srv.preempt_parked == 0
    r = srv.submit(np.arange(1, 6, dtype=np.int32), 2, "interactive")
    assert r.priority == "interactive"
    assert srv.retry_depth("batch") == srv.retry_depth("interactive") == 1
    srv = LLMServer(tm, max_batch=1, max_seq_len=64, max_queue=2,
                    priority=True, device="cpu")
    srv.submit(np.arange(1, 6, dtype=np.int32), 2)
    srv._admit()                         # intake -> slot
    srv.submit(np.arange(1, 6, dtype=np.int32), 2)
    srv.submit(np.arange(1, 6, dtype=np.int32), 2)
    srv._admit()                         # intake -> heap
    assert len(srv._sched) == 2
    with pytest.raises(OverloadError):
        srv.submit(np.arange(1, 6, dtype=np.int32), 2)
