"""The port's mixture-of-experts FFN (``_moe_ffn``, Mixtral) against the
JAX package on ``LlamaConfig.tiny_moe()`` with the same f32 weights
(carried by ``params_from_numpy``), in its two modes: capacity (the
presets' 1.25: slot-major priority, silent drops) and no-drop (0.0).

- ``_moe_ffn`` within 1e-2 of max|y| (the FFN runs in bf16 in both
  packages), with one input where the port's own routing drops slots;
- ``forward`` logits (prefill, then step by step) within 2e-2 of
  max|logit|; ``generate`` tokens equal, paged and dense;
- the engine driven inline beside the JAX engine (the same schedule in
  both): tokens, counters and page ledger equal in every mode — paged
  with the ragged prefill, ``mixed``, ``spec``, ``kvcache``,
  ``priority`` and the slot-static ``paged=False`` — at depths 1 and 2.
  In capacity mode a row's tokens depend on every row of the call
  (padding and inactive rows count), so each mode is held to the JAX
  engine's own; at 0.0 served tokens also equal the port's ``generate``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.models import llama as jl
from bigdl_tpu.llm.serving import LLMServer as JServer

from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tl
from bigdl_tpu_torch.llm.serving import LLMServer

PAGE = 8
FACTORS = [1.25, 0.0]


def _cfgs(factor):
    jc = dataclasses.replace(jl.LlamaConfig.tiny_moe(),
                             expert_capacity_factor=factor)
    return jc, tl.LlamaConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def weights():
    """f32 JAX tiny_moe params and the port's copy of them."""
    p = jl.init_params(jl.LlamaConfig.tiny_moe(), 0, dtype=jnp.float32)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _models(weights, factor):
    jc, tc = _cfgs(factor)
    jp, tp = weights
    jm = jl.LlamaForCausalLM(jc, jp, max_cache_len=128,
                             cache_dtype=jnp.float32)
    tm = tl.LlamaForCausalLM(tc, tp, 128, torch.float32, page_size=PAGE,
                             device="cpu")
    return jm, tm


def _drops(tlp, h, cfg):
    """Whether the port's own routing of ``h`` drops a (token, slot) pair:
    an expert chosen by more pairs than its capacity C."""
    x = torch.from_numpy(h).reshape(-1, h.shape[-1])
    probs = torch.softmax(x @ tlp["router"]["w"].t(), dim=-1)
    idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1).indices
    c = int(np.ceil(x.shape[0] * cfg.num_experts_per_tok / cfg.num_experts
                    * cfg.expert_capacity_factor))
    return int(torch.bincount(idx.reshape(-1)).max()) > c


@pytest.mark.parametrize("factor,tokens", [
    (1.25, 7), (1.25, 32), (4.0, 7), (0.0, 7), (0.0, 32)])
def test_moe_ffn_matches_jax(weights, factor, tokens):
    """Layer 1's experts on a (2, tokens, H) input: capacity mode at the
    preset factor, roomy (C >= S·k: no drop) and no-drop, within 1e-2
    of max|y|. The 32-token input leans towards expert 0's router row,
    so in capacity mode that expert overflows and slots drop."""
    jc, tc = _cfgs(factor)
    jp, tp = weights
    jlp = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    tlp = tl.layer_params(tp["layers"], 1)
    h = np.random.RandomState(tokens).randn(2, tokens, 64).astype(
        np.float32)
    if tokens == 32:
        r0 = np.asarray(jlp["router"]["w"][0])
        h += 3.0 * r0 / np.linalg.norm(r0)
    want = np.asarray(jl._moe_ffn(jlp, jnp.asarray(h), jc))
    got = tl._moe_ffn(tlp, torch.from_numpy(h), tc).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())
    if (factor, tokens) == (1.25, 32):
        assert _drops(tlp, h, tc)
    if factor == 4.0:
        # roomy capacity keeps every pair: the no-drop mode's result
        _, dense = _cfgs(0.0)
        np.testing.assert_allclose(
            got, tl._moe_ffn(tlp, torch.from_numpy(h), dense).numpy(),
            rtol=0, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("factor", FACTORS)
def test_forward_matches_jax(weights, factor):
    """A 6-token prefill, then the same tokens one by one from an empty
    cache: logits within 2e-2 of max|logit| of the JAX ``forward``."""
    jc, tc = _cfgs(factor)
    jp, tp = weights
    toks = np.array([[5, 9, 3, 7, 11, 2]], np.int32)
    runs = []
    for fwd, cache, mk in (
            (jl.forward, jl.init_cache(jc, 1, 16, dtype=jnp.float32),
             jnp.asarray),
            (tl.forward, tl.init_cache(tc, 1, 16, dtype=torch.float32,
                                       device="cpu"), torch.from_numpy)):
        params, cfg = (jp, jc) if fwd is jl.forward else (tp, tc)
        full, _ = fwd(params, cfg, mk(toks), dict(cache),
                      mk(np.arange(6, dtype=np.int32)[None]))
        steps = []
        for t in range(6):
            lg, cache = fwd(params, cfg, mk(toks[:, t:t + 1]), cache,
                            mk(np.array([[t]], np.int32)))
            steps.append(np.asarray(lg)[:, 0])
        runs.append((np.asarray(full), np.stack(steps, 1)))
    (jfull, jstep), (tfull, tstep) = runs
    for got, want in ((tfull, jfull), (tstep, jstep)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("factor", FACTORS)
def test_generate_matches_jax(weights, factor, paged):
    """Greedy ``generate`` on two rows: tokens equal to the JAX
    package's, over the paged token loop and the dense one."""
    jm, tm = _models(weights, factor)
    jm.paged_decode = tm.paged_decode = paged
    ids = np.random.RandomState(1).randint(0, 250, (2, 9)).astype(np.int32)
    assert tm.generate(ids, max_new_tokens=8).tolist() == \
        np.asarray(jm.generate(ids, max_new_tokens=8)).tolist()


MODES = {
    "paged": {},
    "mixed": dict(mixed=True, chunk_tokens=PAGE),
    "spec": dict(spec=True, spec_k=8),
    "kvcache": dict(kvcache=True),
    "priority": dict(priority=True, kvcache=True, num_pages=12),
    "slotted": dict(paged=False),
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
    out = [srv.steps, srv.pages_in_use, srv.prefill_tokens_total]
    if srv.paged:
        out += [srv.prefill_chunks_total, srv.mixed_passes, srv.spec_passes,
                srv.spec_proposed_total, srv.spec_accepted_total,
                srv.preemptions_total, srv.preempt_resumes_total,
                srv.prefix_tokens_saved, srv._budget_avail]
    return out


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax(weights, mode, factor, depth):
    """Tokens, counters and the page ledger equal the JAX engine's in
    each mode; at 0.0 the tokens are also ``generate``'s."""
    jm, tm = _models(weights, factor)
    prompts, lens = _workload()
    classes = (["batch"] * 2 + ["interactive"] * 2 if mode == "priority"
               else [None] * 4)
    kw = dict(max_batch=2, max_seq_len=64, page_size=PAGE,
              pipeline_depth=depth, **MODES[mode])
    ref = JServer(jm, **kw) if mode == "slotted" else \
        JServer(jm, ragged_prefill=True, **kw)
    srv = LLMServer(tm, device="cpu", **kw)
    got = _drive(srv, prompts, lens, classes)
    assert got == _drive(ref, prompts, lens, classes)
    assert _counters(srv) == _counters(ref)
    assert srv.errors == [] and all(len(t) == n for t, n in zip(got, lens))
    assert srv.pages_in_use == (-1 if mode == "slotted" else 0)
    if mode == "priority":
        assert srv.preemptions_total >= 1
    if mode == "spec":
        assert srv.spec_passes > 0
    if mode == "mixed":
        assert srv.mixed_passes > 0
    if factor == 0.0:
        assert got == [tm.generate(p[None], max_new_tokens=n)[0, len(p):]
                       .tolist() for p, n in zip(prompts, lens)]
    ref.stop()
    srv.stop()
