"""The port's slot-static engine (``LLMServer(paged=False)``: one dense
``max_seq_len`` window a slot) against the JAX package's on ``tiny`` and
``tiny_glm`` q4_0 (f32 params and cache): greedy tokens equal to the JAX
slot-static engine's and to the port's ``generate`` at depths 1 and 2,
driven inline so both engines see the same schedule; a live slot's cache
rows bit-equal across another slot's broadcast prefill; the refusals of
the page-pool-only options with the JAX engine's ``ValueError``; the
finished row at the end of its window, whose write the JAX step drops
(the MoE slot-static engine is in ``tests/test_torch_moe.py``)."""

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
from bigdl_tpu_torch.llm.serving import LLMServer, slotted_decode_step


def _pair(preset):
    jc = getattr(jl.LlamaConfig, preset)()
    p = jl.quantize_params(jl.init_params(jc, 0, dtype=jnp.float32),
                           "sym_int4")
    jm = jl.LlamaForCausalLM(jc, p, max_cache_len=64,
                             cache_dtype=jnp.float32)
    tm = tl.LlamaForCausalLM(
        tl.LlamaConfig(**dataclasses.asdict(jc)),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
        64, torch.float32, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny")


def _workload():
    """5 requests over 2 slots: queueing, slot reuse from position 0."""
    rs = np.random.RandomState(3)
    return ([rs.randint(0, 250, n).astype(np.int32)
             for n in (5, 17, 9, 30, 12)], [6, 4, 8, 5, 7])


def _drive(srv, prompts, lens):
    reqs = [srv.submit(p, n) for p, n in zip(prompts, lens)]
    while not all(r.done.is_set() for r in reqs):
        srv._admit()
        srv._step()
    while srv._inflight:
        srv._drain_next()
    return [list(map(int, r.tokens)) for r in reqs]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("preset", ["tiny", "tiny_glm"])
def test_tokens_equal_jax_and_generate(tiny, preset, depth):
    jm, tm = tiny if preset == "tiny" else _pair(preset)
    prompts, lens = _workload()
    kw = dict(max_batch=2, max_seq_len=64, paged=False,
              pipeline_depth=depth)
    ref = JServer(jm, **kw)
    srv = LLMServer(tm, device="cpu", **kw)
    got = _drive(srv, prompts, lens)
    assert got == _drive(ref, prompts, lens)
    assert got == [tm.generate(p[None], max_new_tokens=n)[0, len(p):]
                   .tolist() for p, n in zip(prompts, lens)]
    assert (srv.steps, srv.prefill_tokens_total) == \
        (ref.steps, ref.prefill_tokens_total)
    assert srv.pages_in_use == ref.pages_in_use == -1
    assert not srv._lens.any() and srv.errors == []
    ref.stop()
    srv.stop()


@pytest.mark.parametrize("fails", [False, True])
def test_live_rows_kept_across_admission(tiny, fails):
    """Slot 0 decodes; a request admitted into slot 1 runs the broadcast
    prefill, which writes every row's window: slot 0's rows come back
    bit for bit, and its tokens are those it gets alone. ``fails``: the
    pass raises after writing every layer; the request fails alone and
    slot 0's rows come back all the same."""
    _, tm = tiny
    prompts, _ = _workload()
    srv = LLMServer(tm, max_batch=2, max_seq_len=64, paged=False,
                    pipeline_depth=1, device="cpu")
    a = srv.submit(prompts[3], 8)
    srv._admit()
    for _ in range(3):
        srv._step()
    before = {n: srv._cache[n][:, 0].clone() for n in ("k", "v")}
    if fails:
        forward = srv._fam_forward

        def _raising(*args):
            forward(*args)
            raise RuntimeError("CUDA out of memory")
        srv._fam_forward = _raising
    b = srv.submit(prompts[1], 4)
    srv._admit()
    assert (srv._slots[1] is None) if fails else (srv._slots[1] is b)
    for n in ("k", "v"):
        assert torch.equal(srv._cache[n][:, 0], before[n])
    if fails:
        assert b.done.is_set() and "out of memory" in b.error
        assert len(srv.errors) == 1
        srv._fam_forward = forward
        b = srv.submit(prompts[1], 4)
    while not (a.done.is_set() and b.done.is_set()):
        srv._admit()
        srv._step()
    assert a.tokens == tm.generate(prompts[3][None], max_new_tokens=8)[
        0, len(prompts[3]):].tolist()


@pytest.mark.parametrize("option", [
    {"kvtier": True}, {"mixed": True}, {"priority": True}, {"spec": True}])
def test_page_pool_options_refuse_as_jax(tiny, option):
    jm, tm = tiny
    with pytest.raises(ValueError) as want:
        JServer(jm, paged=False, **option)
    with pytest.raises(ValueError) as got:
        LLMServer(tm, paged=False, device="cpu", **option)
    assert str(got.value) == str(want.value)


def test_window_capped_at_the_model_cache(tiny):
    """``max_seq_len`` is capped at the model's ``max_cache_len`` (64),
    as in the JAX engine, and a request past it is refused at submit."""
    jm, tm = tiny
    srv = LLMServer(tm, max_seq_len=256, paged=False, device="cpu")
    assert srv.max_seq_len == JServer(jm, max_seq_len=256,
                                      paged=False).max_seq_len == 64
    assert tuple(srv._cache["k"].shape[1:3]) == (4, 64)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        srv.submit(np.arange(1, 60, dtype=np.int32), 8)


def test_row_at_window_end_writes_nothing(tiny):
    """A row whose position is the window's length (its request spent,
    its slot not yet released) writes no cache slot, as the JAX
    step's one-hot matches none; the other row writes at its own."""
    _, tm = tiny
    cfg = tm.config
    cache = tl.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    cache["k"].normal_(generator=torch.Generator().manual_seed(0))
    before = cache["k"].clone()
    pos = torch.tensor([8, 3], dtype=torch.int32)
    logits = slotted_decode_step(tm.params, cfg, cache["k"], cache["v"],
                                 pos, torch.tensor([5, 6]))
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(
        logits).all()
    assert torch.equal(cache["k"][:, 0], before[:, 0])
    changed = (cache["k"][:, 1] != before[:, 1]).any(-1).any(-1).any(0)
    assert changed.tolist() == [j == 3 for j in range(8)]
