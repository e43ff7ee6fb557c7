"""The port's ``generate()`` path held against the JAX package on the
same seeded numpy inputs and the same weights (carried across with
``params_from_numpy``): ``online_block_update``, ``_attention`` (single
block, blockwise over ``attn_block_size``, sliding window, ALiBi),
``forward`` (logits and the dense cache it writes), ``pageify_cache``
(bit-identical pools and tables), and ``LlamaForCausalLM.generate``:
greedy tokens identical to the JAX package's on ``tiny``, ``tiny_glm``,
``tiny_qwen2`` and windowed ``tiny`` (q4_0 weights, f32 params and f32
cache, so argmax near-ties cannot flip), for paged and dense decode and
with EOS chunking; ``forward(ring=)``, ``shard`` and
``sequence_parallel`` at world 1 (one gloo rank), the multi-rank cases
being in ``tests/test_torch_parallel.py``. Within the port, dense and
paged decode give the same tokens and the engine serves what
``generate`` gives. The sampled path is
held to its contract only (``jax.random`` cannot be reproduced): shape,
top-k support, same seed → same tokens."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.models import llama as jl
from bigdl_tpu.parallel.ring_attention import (
    online_block_update as j_block_update)

from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import llama as tl
from bigdl_tpu_torch.llm.serving import LLMServer
from bigdl_tpu_torch.llm.transformers import AutoModelForCausalLM
from bigdl_tpu_torch.parallel.ring_attention import online_block_update

CACHE = 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tcfg(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


@contextlib.contextmanager
def _world_of_one():
    """A one-rank gloo group (the Engine's) and its ``{"model": 1,
    "seq": 1}`` mesh; the Engine is cold again after."""
    from bigdl_tpu_torch.parallel import create_mesh
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.reset()
    Engine.init(engine_type="cpu")
    try:
        yield create_mesh({"model": 1, "seq": 1})
    finally:
        Engine.reset()


def _jax_params(jcfg, seed=0, quantize=True):
    """f32 JAX params with random (non-zero) q/k/v biases where the
    config has them, q4_0-quantized and fused when asked."""
    p = jl.init_params(jcfg, seed, dtype=jnp.float32)
    if jcfg.attention_bias:
        rs = np.random.RandomState(seed + 100)
        layers = dict(p["layers"])
        for name in ("q_proj", "k_proj", "v_proj"):
            d = dict(layers[name])
            d["b"] = jnp.asarray(
                rs.randn(*d["b"].shape).astype(np.float32) * 0.5)
            layers[name] = d
        p = dict(p, layers=layers)
    return jl.quantize_params(p, "sym_int4") if quantize else p


def _attn_inputs(seed, B, T, S, Hq, Hkv, D):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, Hq, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    start = S - T - 3                   # queries sit inside the window
    pos = np.broadcast_to(start + np.arange(T), (B, T)).astype(np.int32)
    valid = (np.arange(S) < start + T)[None]
    return q, k, v, pos, valid


class TestAttention:
    def test_online_block_update_matches_jax(self):
        """One flash block update (GQA layout, a ragged mask, a carried
        state): 1e-5 on acc, max and sum (f32, same inputs)."""
        rs = np.random.RandomState(0)
        B, T, Hkv, G, D, S = 2, 5, 2, 3, 8, 11
        qg = rs.randn(B, T, Hkv, G, D).astype(np.float32)
        k = rs.randn(B, S, Hkv, D).astype(np.float32)
        v = rs.randn(B, S, Hkv, D).astype(np.float32)
        mask = rs.rand(B, T, S) > 0.4
        mask[0, 0] = False                  # a row with no valid key
        acc = rs.randn(B, Hkv, G, T, D).astype(np.float32)
        mx = rs.randn(B, Hkv, G, T).astype(np.float32)
        sm = rs.rand(B, Hkv, G, T).astype(np.float32) + 1
        args = (qg, k, v, mask, acc, mx, sm)
        want = j_block_update(*map(jnp.asarray, args), scale=0.3)
        got = online_block_update(*map(torch.from_numpy, args), scale=0.3)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)

    @pytest.mark.parametrize("block,window", [
        (1024, None), (1024, 9), (8, None), (8, 9), (16, 30)])
    def test_attention_matches_jax(self, block, window):
        """Single block (S <= attn_block_size) and blockwise (S = 37 over
        blocks of 8 or 16, the last one short), with and without a
        window, GQA 4:2: 2e-5 (f32; the blockwise path sums in another
        order than one softmax)."""
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(),
                                   attn_block_size=block,
                                   sliding_window=window)
        q, k, v, pos, valid = _attn_inputs(1, 2, 6, 37, 4, 2, 16)
        want = jl._attention(*map(jnp.asarray, (q, k, v, pos, valid)),
                             jcfg)
        got = tl._attention(*map(torch.from_numpy, (q, k, v, pos, valid)),
                            _tcfg(jcfg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)

    def test_blockwise_equals_single_block(self):
        """Within the port: the online softmax over blocks of 8 gives the
        one-pass softmax's output (2e-5)."""
        q, k, v, pos, valid = map(torch.from_numpy,
                                  _attn_inputs(2, 1, 4, 40, 8, 2, 16))
        one = tl._attention(q, k, v, pos, valid, tl.LlamaConfig.tiny())
        blk = tl._attention(q, k, v, pos, valid, dataclasses.replace(
            tl.LlamaConfig.tiny(), attn_block_size=8))
        np.testing.assert_allclose(blk.numpy(), one.numpy(), rtol=2e-5,
                                   atol=2e-5)

    def test_alibi_single_block(self):
        """ALiBi slopes ride the single-block path (2e-5); blockwise
        raises as in the JAX package."""
        q, k, v, pos, valid = _attn_inputs(3, 1, 3, 12, 4, 4, 8)
        slopes = np.array([0.5, 0.25, 0.125, 0.0625], np.float32)
        jcfg = jl.LlamaConfig.tiny()
        want = jl._attention(*map(jnp.asarray, (q, k, v, pos, valid)),
                             jcfg, alibi_slopes=jnp.asarray(slopes))
        targs = list(map(torch.from_numpy, (q, k, v, pos, valid)))
        got = tl._attention(*targs, _tcfg(jcfg),
                            alibi_slopes=torch.from_numpy(slopes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        with pytest.raises(NotImplementedError, match="ALiBi"):
            tl._attention(*targs, dataclasses.replace(
                _tcfg(jcfg), attn_block_size=4),
                alibi_slopes=torch.from_numpy(slopes))

    def test_bf16_cache_upcast(self):
        """A bf16 cache and bf16 queries: scores in f32 on both sides
        (the JAX einsums' preferred_element_type), out cast to bf16 —
        within one bf16 ulp (2^-8 relative) plus 1e-3."""
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), attn_block_size=8)
        q, k, v, pos, valid = _attn_inputs(4, 1, 5, 30, 4, 2, 16)
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        want = jl._attention(jq, jk, jv, jnp.asarray(pos),
                             jnp.asarray(valid), jcfg)
        tq, tk, tv = (params_from_numpy(np.asarray(a), "cpu")
                      for a in (jq, jk, jv))
        got = tl._attention(tq, tk, tv, torch.from_numpy(pos),
                            torch.from_numpy(valid), _tcfg(jcfg))
        assert got.dtype == torch.bfloat16
        w = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), w, rtol=2.0 ** -8,
                                   atol=1e-3)


@pytest.fixture(scope="module")
def tiny_q4():
    jcfg = jl.LlamaConfig.tiny()
    p = _jax_params(jcfg)
    return jcfg, p, params_from_numpy(_np_tree(p), "cpu")


class TestForward:
    @pytest.mark.parametrize("block,window", [(1024, None), (16, None),
                                              (1024, 12), (16, 12)])
    def test_prefill_then_decode(self, tiny_q4, block, window):
        """A 20-token prefill and two decode steps into a cache of 40
        (blockwise when attn_block_size is 16), windowed or not: logits
        within 1e-4 and the written cache within 1e-5 of the JAX
        package's (f32; summation order only)."""
        jcfg, jp, tp = tiny_q4
        jcfg = dataclasses.replace(jcfg, attn_block_size=block,
                                   sliding_window=window)
        tcfg = _tcfg(jcfg)
        rs = np.random.RandomState(5)
        toks = rs.randint(0, 256, (2, 20)).astype(np.int32)
        jc = jl.init_cache(jcfg, 2, 40, dtype=jnp.float32)
        tc = tl.init_cache(tcfg, 2, 40, dtype=torch.float32, device="cpu")
        pos = np.broadcast_to(np.arange(20), (2, 20)).astype(np.int32)
        steps = [(toks, pos)]
        for t in range(2):
            steps.append((rs.randint(0, 256, (2, 1)).astype(np.int32),
                          np.full((2, 1), 20 + t, np.int32)))
        for tk, ps in steps:
            wl, jc = jl.forward(jp, jcfg, jnp.asarray(tk), jc,
                                jnp.asarray(ps))
            gl, tc = tl.forward(tp, tcfg, torch.from_numpy(tk), tc,
                                torch.from_numpy(ps))
            assert gl.dtype == torch.float32
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                       rtol=0, atol=1e-4)
        assert tc["pos"] == int(jc["pos"]) == 22
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=0, atol=1e-5)

    def test_overflow_and_unported_options_raise(self, tiny_q4):
        _, _, tp = tiny_q4
        cfg = tl.LlamaConfig.tiny()
        cache = tl.init_cache(cfg, 1, 4, dtype=torch.float32, device="cpu")
        toks = torch.zeros((1, 5), dtype=torch.int32)
        pos = torch.arange(5)[None]
        with pytest.raises(ValueError, match="overflows"):
            tl.forward(tp, cfg, toks, cache, pos)
        with pytest.raises(NotImplementedError, match="eager"):
            tl.forward(tp, cfg, toks[:, :2], cache, pos[:, :2], unroll=4)
        # ring= at world 1 (one gloo rank): a single causal block, within
        # f32 order of the dense prefill, logits and cache
        ids = torch.from_numpy(np.random.RandomState(5).randint(
            0, 256, (2, 12)).astype(np.int32))
        pos = torch.arange(12).expand(2, 12)
        dense = tl.forward(tp, cfg, ids, tl.init_cache(
            cfg, 2, 16, dtype=torch.float32, device="cpu"), pos)
        with _world_of_one() as mesh:
            ring = tl.forward(tp, cfg, ids, tl.init_cache(
                cfg, 2, 16, dtype=torch.float32, device="cpu"), pos,
                ring=(mesh, "seq"))
        np.testing.assert_allclose(ring[0].numpy(), dense[0].numpy(),
                                   rtol=1e-4, atol=1e-4)
        for key in ("k", "v"):
            np.testing.assert_allclose(ring[1][key].numpy(),
                                       dense[1][key].numpy(), atol=1e-5)


class TestParams:
    @pytest.mark.parametrize("preset", [
        "llama2_7b", "llama3_8b", "mistral_7b", "qwen2_7b", "tiny_qwen2",
        "glm4_9b", "tiny_glm", "tiny", "mixtral_8x7b", "tiny_moe"])
    def test_presets_equal_jax(self, preset):
        assert dataclasses.asdict(getattr(tl.LlamaConfig, preset)()) == \
            dataclasses.asdict(getattr(jl.LlamaConfig, preset)())

    @pytest.mark.parametrize("raw", [
        {"model_type": "mistral", "hidden_size": 64, "sliding_window": 16,
         "num_attention_heads": 4, "num_key_value_heads": 2},
        {"model_type": "qwen2", "sliding_window": 4096,
         "use_sliding_window": False, "rms_norm_eps": 1e-6},
        {"model_type": "glm", "partial_rotary_factor": 0.5,
         "attention_bias": True},
        {"model_type": "mixtral", "num_local_experts": 8,
         "num_experts_per_tok": 2}])
    def test_from_hf_equals_jax(self, raw):
        shim = type("HFConfig", (), raw)()
        assert dataclasses.asdict(tl.LlamaConfig.from_hf(shim)) == \
            dataclasses.asdict(jl.LlamaConfig.from_hf(shim))

    @pytest.mark.parametrize("preset", ["tiny", "tiny_qwen2", "tiny_glm"])
    def test_init_params_shapes_scales_dtypes(self, preset):
        """The JAX package's tree: same keys, shapes and dtypes; weights
        with std 1/sqrt(fan_in) (0.02 for the embedding), zero biases,
        unit norms; the same seed gives the same weights."""
        jcfg = getattr(jl.LlamaConfig, preset)()
        want = _np_tree(jl.init_params(jcfg, 0))
        got = tl.init_params(_tcfg(jcfg), 0, device="cpu")
        again = tl.init_params(_tcfg(jcfg), 0, device="cpu")
        flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert set(map(str, flat_w)) == set(map(str, flat_g))
        for path, w in flat_w.items():
            g = flat_g[path]
            assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        assert torch.equal(got["lm_head"]["w"], again["lm_head"]["w"])
        emb = got["embed_tokens"].float()
        assert abs(emb.std().item() - 0.02) < 0.002
        down = got["layers"]["down_proj"]["w"].float()
        assert abs(down.std().item() * np.sqrt(128) - 1) < 0.1
        if jcfg.attention_bias:
            assert not got["layers"]["q_proj"]["b"].any()
        assert torch.all(got["norm"] == 1)

    @pytest.mark.parametrize("lm_head,fuse", [(False, True), (True, True),
                                              (False, False)])
    def test_quantize_params_flags(self, lm_head, fuse):
        """``quantize_lm_head`` and ``fuse``: bit-identical planes."""
        jcfg = jl.LlamaConfig.tiny_qwen2()
        dense = jl.init_params(jcfg, 1, dtype=jnp.float32)
        want = _np_tree(jl.quantize_params(dense, "sym_int4",
                                           quantize_lm_head=lm_head,
                                           fuse=fuse))
        got = tl.quantize_params(params_from_numpy(_np_tree(dense), "cpu"),
                                 "sym_int4", quantize_lm_head=lm_head,
                                 fuse=fuse)
        assert set(got["layers"]) == set(want["layers"])
        assert set(got["lm_head"]) == set(want["lm_head"])
        for name, d in want["layers"].items():
            if isinstance(d, dict):
                for k in d:
                    np.testing.assert_array_equal(
                        got["layers"][name][k].numpy(), d[k])
        for k in ("q", "scale", "w"):
            if k in want["lm_head"]:
                np.testing.assert_array_equal(got["lm_head"][k].numpy(),
                                              want["lm_head"][k])

    @pytest.mark.parametrize("S,page", [(37, 16), (64, 8), (5, 16)])
    def test_pageify_cache_bit_identical(self, S, page):
        rs = np.random.RandomState(6)
        shape = (2, 3, S, 2, 8)
        k = rs.randn(*shape).astype(np.float32)
        v = rs.randn(*shape).astype(np.float32)
        jk, jv, jbt = jl.pageify_cache({"k": jnp.asarray(k),
                                        "v": jnp.asarray(v),
                                        "pos": jnp.int32(S)}, page=page)
        tk, tv, tbt = tl.pageify_cache({"k": torch.from_numpy(k),
                                        "v": torch.from_numpy(v),
                                        "pos": S}, page=page)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
        assert tbt.dtype == torch.int32
        with pytest.raises(ValueError, match="lane"):
            tl.pageify_cache({"k": torch.from_numpy(k),
                              "v": torch.from_numpy(v), "pos": S}, page=12)


def _cfg(name):
    if name == "tiny_window":
        return dataclasses.replace(jl.LlamaConfig.tiny(), sliding_window=24)
    if name == "tiny_gqa16":
        # GLM-4-9B's group, 16 query heads on one kv head, at tiny width
        return dataclasses.replace(jl.LlamaConfig.tiny_glm(), hidden_size=128,
                                   num_attention_heads=16,
                                   num_key_value_heads=1)
    return getattr(jl.LlamaConfig, name)()


CONFIGS = ["tiny", "tiny_glm", "tiny_qwen2", "tiny_window", "tiny_gqa16"]


@pytest.fixture(scope="module", params=CONFIGS)
def models(request):
    """The same f32 q4_0 weights as JAX and port models, paged and dense
    decode, f32 caches; a prompt of 30 tokens (past the window of 24)."""
    jcfg = _cfg(request.param)
    p = _jax_params(jcfg)
    tp = params_from_numpy(_np_tree(p), "cpu")
    out = {}
    for paged in (True, False):
        out["jax", paged] = jl.LlamaForCausalLM(
            jcfg, p, max_cache_len=CACHE, cache_dtype=jnp.float32,
            paged_decode=paged)
        out["port", paged] = tl.LlamaForCausalLM(
            _tcfg(jcfg), tp, max_cache_len=CACHE, cache_dtype=torch.float32,
            paged_decode=paged, page_size=8, device="cpu")
    ids = np.random.RandomState(7).randint(0, 256, (2, 30)).astype(np.int32)
    return out, ids


NEW = 16


class TestGenerate:
    @pytest.mark.parametrize("paged", [True, False])
    def test_greedy_identical_to_jax(self, models, paged):
        m, ids = models
        want = m["jax", paged].generate(ids, max_new_tokens=NEW)
        got = m["port", paged].generate(ids, max_new_tokens=NEW)
        assert got.dtype == np.int32 and got.shape == (2, 30 + NEW)
        np.testing.assert_array_equal(got, want)

    def test_dense_equals_paged(self, models):
        m, ids = models
        np.testing.assert_array_equal(
            m["port", True].generate(ids, max_new_tokens=NEW),
            m["port", False].generate(ids, max_new_tokens=NEW))

    @pytest.mark.parametrize("paged", [True, False])
    def test_eos_chunked_identical_to_jax(self, models, paged):
        """EOS with chunks of 3 tokens: the ``finished`` carry freezes a
        row across chunk boundaries; tokens equal the JAX package's."""
        m, ids = models
        base = m["port", paged].generate(ids, max_new_tokens=NEW)[0, 30:]
        j = next(i for i in range(2, NEW) if base[i] not in base[:i])
        eos = int(base[j])
        kw = dict(max_new_tokens=NEW, eos_token_id=eos, decode_chunk=3)
        want = m["jax", paged].generate(ids, **kw)
        got = m["port", paged].generate(ids, **kw)
        np.testing.assert_array_equal(got, want)
        row = got[0, 30:]
        assert row[j] == eos and np.all(row[j:] == eos)

    def test_engine_serves_jax_tokens(self, models):
        """The port's ``LLMServer`` (ragged prefill, paged decode) serves
        each prompt the greedy tokens of the JAX package's ``generate``."""
        m, ids = models
        want = m["jax", True].generate(ids, max_new_tokens=NEW)[:, 30:]
        srv = LLMServer(m["port", True], max_batch=2, max_seq_len=48,
                        device="cpu").start()
        try:
            got = [r.get(timeout=600) for r in
                   [srv.submit(row, max_new_tokens=NEW) for row in ids]]
        finally:
            srv.stop()
        assert got == want.tolist()

    def test_sampled_contract(self, models):
        """Same seed → same tokens; every token in the top-k support of
        the logits it was drawn from (checked on the first)."""
        m, ids = models
        tm = m["port", True]
        kw = dict(max_new_tokens=6, do_sample=True, temperature=0.8,
                  top_k=3, seed=11)
        a, b = tm.generate(ids, **kw), tm.generate(ids, **kw)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (2, 36) and a.max() < 256 and a.min() >= 0
        logits, _ = tm(ids)
        top = torch.topk(logits[:, -1], 3).indices.numpy()
        assert all(a[r, 30] in top[r] for r in range(2))


def test_engine_serves_generate_tokens(tiny_q4):
    """The port's engine serves, request by request, the tokens that the
    port's generate gives (greedy, f32)."""
    _, _, tp = tiny_q4
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), tp, max_cache_len=CACHE,
                             cache_dtype=torch.float32, page_size=8,
                             device="cpu")
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 256, n).astype(np.int32) for n in (5, 19)]
    srv = LLMServer(tm, max_batch=2, max_seq_len=48, device="cpu").start()
    try:
        served = [r.get(timeout=600) for r in
                  [srv.submit(p, max_new_tokens=7) for p in prompts]]
    finally:
        srv.stop()
    for p, toks in zip(prompts, served):
        assert list(tm.generate(p[None], max_new_tokens=7)[0, len(p):]) \
            == toks


class TestFacade:
    def test_from_config_and_quantize(self):
        m = tl.LlamaForCausalLM.from_config(tl.LlamaConfig.tiny(), seed=2,
                                            load_in_low_bit="sym_int4",
                                            max_cache_len=32, device="cpu")
        assert "q" in m.params["layers"]["qkv_proj"]
        assert "w" in m.params["lm_head"]            # lm_head stays dense
        assert m.max_cache_len == 32 and m.paged_decode
        out = m.generate(np.array([[1, 2, 3]]), max_new_tokens=4)
        assert out.shape == (1, 7)
        with pytest.raises(ValueError, match="exceeds cache"):
            m.generate(np.zeros((1, 30), np.int32), max_new_tokens=4)

    def test_argument_order_is_the_jax_one(self, tiny_q4):
        _, _, tp = tiny_q4
        m = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), tp, 100,
                                torch.float32, 1, False, 8, "cpu")
        assert (m.max_cache_len, m.cache_dtype, m.paged_decode,
                m.page_size) == (100, torch.float32, False, 8)

    def test_unported_options_raise(self, tiny_q4):
        jcfg, jp, tp = tiny_q4
        # shard and sequence_parallel at world 1 (one gloo rank): the
        # JAX package's greedy tokens (the W = 2 and 4 cases are in
        # tests/test_torch_parallel.py)
        ids = np.array([[5, 9, 2, 7]], np.int32)
        want = np.asarray(jl.LlamaForCausalLM(
            jcfg, jp, max_cache_len=32, cache_dtype=jnp.float32).generate(
                ids, max_new_tokens=5))
        with _world_of_one() as mesh:
            for entry in ("shard", "sequence_parallel"):
                m = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), tp, 32,
                                        torch.float32, device="cpu")
                m = m.shard(mesh) if entry == "shard" else \
                    m.sequence_parallel(mesh)
                np.testing.assert_array_equal(
                    m.generate(ids, max_new_tokens=5), want, err_msg=entry)
        m = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), tp, device="cpu")
        with pytest.raises(NotImplementedError, match="eager"):
            tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), tp, decode_unroll=8,
                                device="cpu")
        # MoE expert weights refuse q4_0 as in the JAX package, word for
        # word: in quantize_params and, before any weight, from_config
        jp = jl.init_params(jl.LlamaConfig.tiny_moe(), 0, dtype=jnp.float32)
        with pytest.raises(NotImplementedError) as want:
            jl.quantize_params(jp, "sym_int4")
        moe = tl.LlamaConfig.tiny_moe()
        for call in (lambda: tl.quantize_params(params_from_numpy(
                         _np_tree(jp), "cpu"), "sym_int4"),
                     lambda: tl.LlamaForCausalLM.from_config(
                         moe, load_in_low_bit="sym_int4", device="cpu"),
                     lambda: AutoModelForCausalLM.from_pretrained(
                         moe, load_in_4bit=True, device="cpu")):
            with pytest.raises(NotImplementedError) as got:
                call()
            assert str(got.value) == str(want.value)

    def test_entry_points_raise_without_gpu(self, monkeypatch, tiny_q4):
        _, _, tp = tiny_q4
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = tl.LlamaConfig.tiny()
        for call in (lambda: tl.init_params(cfg),
                     lambda: tl.init_cache(cfg, 1, 8),
                     lambda: tl.LlamaForCausalLM(cfg, tp),
                     lambda: tl.LlamaForCausalLM.from_config(cfg)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
