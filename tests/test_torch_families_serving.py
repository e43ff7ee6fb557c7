"""The port's ``LLMServer`` on GPT-NeoX and StarCoder against the JAX
engine (tiny q4_0, f32 weights and KV, page 8), both driven inline with
one schedule: greedy tokens and every counter equal over the paged
engine, the prefix cache, mixed dispatch, speculation and priority, at
depths 1 and 2, and over the host KV tier and the chain handoff; the
served tokens equal the family's ``generate``. And
the family dispatch: each entry point the engine and ``generate`` run is
the family module's, never Llama's; Bloom and ``paged=False`` refuse
with the JAX engine's words."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.models import bloom as jb
from bigdl_tpu.llm.models import gptneox as jn
from bigdl_tpu.llm.models import starcoder as js
from bigdl_tpu.llm.serving import LLMServer as JServer

from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import bloom as tb
from bigdl_tpu_torch.llm.models import gptneox as tn
from bigdl_tpu_torch.llm.models import llama as tl
from bigdl_tpu_torch.llm.models import starcoder as ts
from bigdl_tpu_torch.llm.serving import LLMServer

PAGE = 8
FAMILIES = {"neox": (jn, tn, "GptNeoX", {}),
            "neox-seq": (jn, tn, "GptNeoX", {"use_parallel_residual": False}),
            "starcoder": (js, ts, "StarCoder", {}),
            "bloom": (jb, tb, "Bloom", {})}


def _models(name):
    """The JAX and the port's model on the same f32 q4_0 weights."""
    jm, tm, cls, over = FAMILIES[name]
    jc = dataclasses.replace(getattr(jm, cls + "Config").tiny(), **over)
    p = jm.quantize_params(jm.init_params(jc, 0, dtype=jnp.float32))
    jmod = getattr(jm, cls + "ForCausalLM")(jc, p, max_cache_len=128,
                                            cache_dtype=jnp.float32)
    tmod = getattr(tm, cls + "ForCausalLM")(
        getattr(tm, cls + "Config")(**dataclasses.asdict(jc)),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
        128, torch.float32, page_size=PAGE, device="cpu")
    return jmod, tmod


MODES = {
    "paged": {},
    "kvcache": dict(kvcache=True),
    "mixed": dict(mixed=True, chunk_tokens=PAGE, kvcache=True),
    "spec": dict(spec=True, spec_k=8),
    "priority": dict(priority=True, kvcache=True, num_pages=12),
}


def _workload():
    """A prompt falling into a cycle (drafts), two sharing a prefix
    (cache hits) and a long one (chunks); the last two arrive after
    three passes, as interactive requests under ``priority``."""
    rs = np.random.RandomState(42)
    pattern = rs.randint(0, 250, 5).astype(np.int32)
    shared = rs.randint(0, 250, 12).astype(np.int32)
    prompts = [np.tile(pattern, 4), np.concatenate([shared, [3, 4]]),
               np.concatenate([shared, rs.randint(0, 250, 7)]).astype(
                   np.int32), rs.randint(0, 250, 21).astype(np.int32)]
    return prompts, [10, 5, 6, 4]


def _drive(srv, prompts, lens, classes):
    """Serve inline (``_admit`` then ``_step``, the engine loop's pass):
    both packages' engines see the same schedule."""
    reqs, n = [], 0
    while len(reqs) < len(prompts) or not all(r.done.is_set()
                                              for r in reqs):
        if n in (0, 3):
            j = 0 if n == 0 else 2
            reqs += [srv.submit(p, m, priority=c) for p, m, c in zip(
                prompts[j:j + 2], lens[j:j + 2], classes[j:j + 2])]
        srv._admit()
        srv._step()
        n += 1
    while srv._inflight:
        srv._drain_next()
    return [list(map(int, r.tokens)) for r in reqs]


def _counters(srv):
    return [srv.steps, srv.pages_in_use, srv.prefill_tokens_total,
            srv.prefill_chunks_total, srv.mixed_passes, srv.spec_passes,
            srv.spec_proposed_total, srv.spec_accepted_total,
            srv.spec_emitted_total, srv.preemptions_total,
            srv.preempt_resumes_total, srv.prefix_tokens_saved,
            srv._budget_avail]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["neox", "starcoder"])
def test_engine_matches_jax(name, mode, depth):
    """Tokens and counters equal the JAX engine's in each mode; each
    mode did its work; the tokens are the family's ``generate``'s."""
    jmod, tmod = _models(name)
    prompts, lens = _workload()
    classes = (["batch"] * 2 + ["interactive"] * 2 if mode == "priority"
               else [None] * 4)
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE,
              pipeline_depth=depth, **MODES[mode])
    ref = JServer(jmod, ragged_prefill=True, **kw)
    srv = LLMServer(tmod, device="cpu", **kw)
    got = _drive(srv, prompts, lens, classes)
    assert got == _drive(ref, prompts, lens, classes)
    assert _counters(srv) == _counters(ref)
    assert srv.errors == [] and srv.pages_in_use == 0
    assert {"priority": srv.preemptions_total, "spec": srv.spec_passes,
            "mixed": srv.mixed_passes, "kvcache": srv.prefix_tokens_saved,
            "paged": 1}[mode] > 0
    assert got == [tmod.generate(p[None], max_new_tokens=n)[0, len(p):]
                   .tolist() for p, n in zip(prompts, lens)]
    ref.stop()
    srv.stop()


def test_sequential_residual_served():
    """GPT-NeoX with ``use_parallel_residual=False`` through the mixed
    engine: the JAX engine's tokens and counters."""
    jmod, tmod = _models("neox-seq")
    prompts, lens = _workload()
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE, **MODES["mixed"])
    ref = JServer(jmod, ragged_prefill=True, **kw)
    srv = LLMServer(tmod, device="cpu", **kw)
    assert _drive(srv, prompts, lens, [None] * 4) == \
        _drive(ref, prompts, lens, [None] * 4)
    assert _counters(srv) == _counters(ref)
    ref.stop()
    srv.stop()


@pytest.mark.parametrize("name", ["neox", "starcoder"])
def test_dispatch_runs_the_family(name, monkeypatch):
    """Every entry point the engine holds is the family module's; the
    decode step it captures and ``generate``'s paged loop step through
    the family's decode step, never Llama's."""
    _, tmod = _models(name)
    fam = FAMILIES[name][1]
    calls = {"sampled": 0, "loop": 0}
    sampled, step = fam.paged_decode_step_sampled, fam.paged_decode_step

    def counted_sampled(*a, **k):
        calls["sampled"] += 1
        return sampled(*a, **k)

    def counted_step(*a, **k):
        calls["loop"] += 1
        return step(*a, **k)

    def no_llama(*a, **k):
        raise AssertionError("a family ran Llama's decode step")

    monkeypatch.setattr(fam, "paged_decode_step_sampled", counted_sampled)
    monkeypatch.setattr(type(tmod), "_paged_step", staticmethod(counted_step))
    monkeypatch.setattr("bigdl_tpu_torch.llm.serving.paged_decode_step",
                        no_llama)
    monkeypatch.setattr("bigdl_tpu_torch.llm.serving."
                        "paged_decode_step_sampled", no_llama)
    srv = LLMServer(tmod, max_batch=2, max_seq_len=64, page_size=PAGE,
                    device="cpu")
    for attr, n in (("forward", "forward"),
                    ("ragged_prefill", "paged_prefill_ragged"),
                    ("partial_prefill", "paged_prefill_partial"),
                    ("mixed_step", "paged_step_mixed"),
                    ("spec_step", "paged_step_spec")):
        assert getattr(srv, "_fam_" + attr) is getattr(fam, n), n
    assert srv._fam_sampled_step is counted_sampled
    out = srv.submit([7, 3, 11, 2], 4)
    while not out.done.is_set():
        srv._admit()
        srv._step()
    srv.stop()
    assert calls["sampled"] >= 4
    tmod.generate(np.array([[7, 3, 11, 2]], np.int32), max_new_tokens=3)
    assert calls["loop"] == 3


@pytest.mark.parametrize("name", ["neox", "starcoder", "bloom"])
def test_refusals_match_jax(name):
    """Bloom (no paged decode step) refuses the engine, and every family
    refuses the slot-static engine, with the JAX engine's words."""
    jmod, tmod = _models(name)
    for kw in ({}, {"paged": False}):
        if name != "bloom" and not kw:
            continue
        with pytest.raises(NotImplementedError) as want:
            JServer(jmod, **kw)
        with pytest.raises(NotImplementedError) as got:
            LLMServer(tmod, device="cpu", **kw)
        assert str(got.value) == str(want.value)
        assert ("paged decode" if not kw else "slot-static") in str(
            got.value)


def test_llama_keeps_its_steps():
    """A Llama-stack model keeps the llama module's entry points."""
    cfg = tl.LlamaConfig.tiny()
    srv = LLMServer(tl.LlamaForCausalLM(cfg, tl.init_params(
        cfg, 0, device="cpu"), page_size=PAGE, device="cpu"),
        max_batch=1, max_seq_len=32, page_size=PAGE, device="cpu")
    from bigdl_tpu_torch.llm import serving
    assert srv._fam_forward is tl.forward
    assert srv._fam_ragged_prefill is tl.paged_prefill_ragged
    assert srv._fam_sampled_step is serving.paged_decode_step_sampled
    srv.stop()


def _tier_workload():
    """Four 16-token prefixes with short tails, twice: a 9-page pool
    holds about two of the chains, so pass 1 spills and pass 2 fetches."""
    rs = np.random.RandomState(17)
    groups = [rs.randint(0, 250, 16).astype(np.int32) for _ in range(4)]
    prompts = [np.concatenate([groups[g], rs.randint(
        0, 250, 2 + (g + rnd) % 3).astype(np.int32)])
        for rnd in range(2) for g in range(4)]
    return prompts, [int(rs.randint(2, 5)) for _ in prompts]


def _one_by_one(srv, prompts, lens):
    out = []
    for p, n in zip(prompts, lens):
        r = srv.submit(p, n)
        while not r.done.is_set():
            srv._admit()
            srv._step()
        out.append(list(map(int, r.tokens)))
    while srv._inflight:
        srv._drain_next()
    return out


def _tier_ledger(srv):
    st = srv._kv.debug_stats()
    return {k: st[k] for k in ("pages_pinned", "budget_avail", "pages_free",
                               "hits", "misses", "evictions",
                               "prefix_tokens_reused", "tier")}


@pytest.mark.parametrize("name", ["neox", "starcoder"])
def test_kvtier_and_handoff_match_jax(name):
    """The host KV tier on a family model (StarCoder: one K/V head a
    page), both tiers migrating inline: tokens, the tier's counters, the
    page ledger and the warm chains equal the JAX engine's. Then a chain
    exported by each engine (blobs of the same size) imports into a
    fresh port engine, which serves the prompt from its host tier with
    the family's ``generate`` tokens."""
    from bigdl_tpu.utils.conf import conf
    jmod, tmod = _models(name)
    tier = dict(max_batch=2, max_seq_len=64, page_size=PAGE, num_pages=9,
                kvcache=True, kvtier=True, host_pages=32)
    prompts, lens = _tier_workload()
    conf.set("bigdl.llm.kvtier.sync", "true")
    try:
        ref = JServer(jmod, ragged_prefill=True, **tier)
        srv = LLMServer(tmod, device="cpu", kvtier_sync=True, **tier)
        got = _one_by_one(srv, prompts, lens)
        assert got == _one_by_one(ref, prompts, lens)
        assert got == [tmod.generate(p[None], max_new_tokens=n)[0, len(p):]
                       .tolist() for p, n in zip(prompts, lens)]
        st = _tier_ledger(srv)
        assert st == _tier_ledger(ref)
        assert st["tier"]["spills"] > 0 and st["tier"]["fetches"] > 0
        assert st["pages_pinned"] == 0 and srv.errors == []
        assert srv.warm_chains() == ref.warm_chains() != []
        prompt = prompts[0]
        blob, jblob = srv.export_chain(prompt), ref.export_chain(prompt)
        assert len(blob) == len(jblob)
        want = [tmod.generate(prompt[None], max_new_tokens=5)[0, len(prompt):]
                .tolist()]
        for bl in (blob, jblob):
            dst = LLMServer(tmod, device="cpu", kvtier_sync=True, **tier)
            assert dst.import_chain(bl) == len(prompt) // PAGE
            assert _one_by_one(dst, [prompt], [5]) == want
            assert dst._tier.handoffs_in == 1 and dst._tier.fetches == 2
            assert dst._kv.prefix_tokens_reused == 2 * PAGE
            dst.stop()
        ref.stop()
        srv.stop()
    finally:
        conf.unset("bigdl.llm.kvtier.sync")
