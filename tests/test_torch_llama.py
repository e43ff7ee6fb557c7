"""The port's Llama layer math and its two engine steps held against the
JAX package on ``LlamaConfig.tiny()`` with q4_0 weights carried across
by ``params_from_numpy``: ``rms_norm``, ``rope`` (both modes),
``fuse_decoder_params``, ``paged_decode_step`` and
``paged_prefill_ragged`` (logits and the written pools), plus the
sampling contract and the weight carry itself."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.models import llama as jllama
from bigdl_tpu.llm.serving import paged_decode_step as j_decode

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.kernels.sampling import sample_tokens
from bigdl_tpu_torch.llm.models import llama as tllama
from bigdl_tpu_torch.llm.serving import paged_decode_step

PAGE = 8
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# logits tolerance: f32 params differ only in summation order; bf16
# params round activations and pool K/V to bf16 at the same points, but
# the JAX CPU path multiplies bf16 weights while the port multiplies the
# exact f32 dequantized weights, so rounding differs at the 1e-2 level
LOGIT_ATOL = {"f32": 1e-4, "bf16": 6e-2}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_np(t):
    return t.to(torch.float32).numpy()


@pytest.fixture(scope="module")
def models():
    """(jax params, torch params) per dtype, q4_0, fused — the same
    weights on both sides."""
    cfg = jllama.LlamaConfig.tiny()
    out = {}
    for name, jdt in JDT.items():
        p = jllama.quantize_params(jllama.init_params(cfg, 0, dtype=jdt),
                                   "sym_int4")
        out[name] = (p, params_from_numpy(_np_tree(p), "cpu"))
    return cfg, tllama.LlamaConfig.tiny(), out


def _pools(seed, cfg, dt, P=12):
    rs = np.random.RandomState(seed)
    shape = (cfg.num_hidden_layers, P, cfg.num_key_value_heads, PAGE,
             cfg.head_dim)
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    jk, jv = jnp.asarray(k, JDT[dt]), jnp.asarray(v, JDT[dt])
    return jk, jv, params_from_numpy(np.asarray(jk), "cpu"), \
        params_from_numpy(np.asarray(jv), "cpu")


class TestLayers:
    def test_rms_norm(self):
        """f32 normalise, model-dtype cast, then scale by w: 1e-6."""
        rs = np.random.RandomState(0)
        x = rs.randn(2, 3, 64).astype(np.float32)
        w = rs.rand(64).astype(np.float32)
        want = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
        got = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                              1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("mode,partial", [("half", 1.0), ("glm", 0.5)])
    def test_rope(self, mode, partial):
        """Angles up to ~100 rad in f32 on both sides: 1e-5."""
        rs = np.random.RandomState(1)
        x = rs.randn(2, 5, 3, 16).astype(np.float32)
        pos = rs.randint(0, 100, (2, 5)).astype(np.int32)
        want = jllama.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                           mode, partial)
        got = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos),
                          10000.0, mode, partial)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_fuse_decoder_params(self):
        cfg = jllama.LlamaConfig.tiny()
        dense = jllama.init_params(cfg, 1, dtype=jnp.float32)
        want = _np_tree(jllama.fuse_decoder_params(dense))
        got = tllama.fuse_decoder_params(params_from_numpy(_np_tree(dense),
                                                           "cpu"))
        assert set(got["layers"]) == set(want["layers"])
        np.testing.assert_array_equal(
            got["layers"]["qkv_proj"]["w"].numpy(),
            want["layers"]["qkv_proj"]["w"])

    def test_params_from_numpy_bf16_bit_exact(self):
        a = np.asarray(jnp.asarray(np.linspace(-3, 3, 50), jnp.bfloat16))
        t = params_from_numpy({"a": a, "qtype": "sym_int4"}, "cpu")
        assert t["a"].dtype == torch.bfloat16 and t["qtype"] == "sym_int4"
        np.testing.assert_array_equal(
            t["a"].view(torch.int16).numpy(), a.view(np.int16))

    def test_linear_shapes_match(self):
        assert tllama.linear_shapes(tllama.LlamaConfig.llama2_7b()) == \
            jllama.linear_shapes(jllama.LlamaConfig.llama2_7b())


class TestSteps:
    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    def test_paged_decode_step(self, models, dt):
        jcfg, tcfg, m = models
        jp, tp = m[dt]
        jk, jv, tk, tv = _pools(2, jcfg, dt)
        bt = np.array([[3, 4, 5, 0], [6, 7, 0, 0], [0, 0, 0, 0]], np.int32)
        lens = np.array([20, 9, 0], np.int32)
        toks = np.array([5, 77, 200], np.int32)
        wl, wk, wv = j_decode(jp, jcfg, jk, jv, jnp.asarray(bt),
                              jnp.asarray(lens), jnp.asarray(toks),
                              page=PAGE)
        gl, gk, gv = paged_decode_step(tp, tcfg, tk, tv,
                                       torch.from_numpy(bt),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(toks), page=PAGE)
        assert gl.dtype == torch.float32
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                   atol=LOGIT_ATOL[dt], rtol=0)
        # the new K/V landed where the JAX step put them
        np.testing.assert_allclose(_to_np(gk), np.asarray(wk, np.float32),
                                   atol=LOGIT_ATOL[dt], rtol=0)
        np.testing.assert_allclose(_to_np(gv), np.asarray(wv, np.float32),
                                   atol=LOGIT_ATOL[dt], rtol=0)

    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    @pytest.mark.parametrize("offset,length", [(0, 13), (11, 5)])
    def test_paged_prefill_ragged(self, models, dt, offset, length):
        """Offset 0 (whole prompt) and offset > 0 (prefix pages read in
        place): last-token logits and every pool write."""
        jcfg, tcfg, m = models
        jp, tp = m[dt]
        jk, jv, tk, tv = _pools(3, jcfg, dt)
        rs = np.random.RandomState(4)
        bucket = 16
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :length] = rs.randint(0, 256, length)
        bt_row = np.array([2, 3, 4, 5], np.int32)
        pos = offset + np.arange(bucket)
        T = offset + length
        phys = np.where(pos < T, bt_row[np.minimum(pos // PAGE, 3)],
                        0).astype(np.int32)
        slots = (pos % PAGE).astype(np.int32)
        wk, wv, wl = jllama.paged_prefill_ragged(
            jp, jcfg, jk, jv, jnp.asarray(toks), jnp.int32(length),
            jnp.int32(offset), jnp.asarray(bt_row), jnp.asarray(phys),
            jnp.asarray(slots), jnp.int32(0), jnp.int32(0), page=PAGE)
        gk, gv, gl = tllama.paged_prefill_ragged(
            tp, tcfg, tk, tv, torch.from_numpy(toks), length, offset,
            torch.from_numpy(bt_row), torch.from_numpy(phys),
            torch.from_numpy(slots), 0, 0, page=PAGE)
        assert gl.shape == (tcfg.vocab_size,)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                   atol=LOGIT_ATOL[dt], rtol=0)
        # compare real pages (page 0 takes the padding's duplicate writes)
        np.testing.assert_allclose(_to_np(gk)[:, 1:],
                                   np.asarray(wk, np.float32)[:, 1:],
                                   atol=LOGIT_ATOL[dt], rtol=0)
        np.testing.assert_allclose(_to_np(gv)[:, 1:],
                                   np.asarray(wv, np.float32)[:, 1:],
                                   atol=LOGIT_ATOL[dt], rtol=0)


class TestSampling:
    def test_greedy_is_first_argmax(self):
        logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 5.0, 2.0]])
        toks = sample_tokens(logits)
        assert toks.dtype == torch.int32 and toks.tolist() == [1, 0]

    def test_top_k_support_and_seed(self):
        """Sampled tokens stay inside the top-k set; the same seed gives
        the same tokens; top_k >= vocab is no filter (and no error)."""
        rs = np.random.RandomState(5)
        logits = torch.from_numpy(rs.randn(64, 50).astype(np.float32))
        topk = set()
        for r in range(64):
            topk |= {(r, int(i)) for i in torch.topk(logits[r], 3).indices}
        draws = [sample_tokens(logits, torch.Generator().manual_seed(7),
                               do_sample=True, temperature=0.8, top_k=3)
                 for _ in range(2)]
        assert torch.equal(draws[0], draws[1])
        assert all((r, int(t)) in topk for r, t in enumerate(draws[0]))
        wide = sample_tokens(logits, torch.Generator().manual_seed(7),
                             do_sample=True, top_k=500)
        assert wide.shape == (64,) and int(wide.max()) < 50


class TestDevice:
    def test_resolve_device(self, monkeypatch):
        assert resolve_device("cpu") == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")

    def test_entry_points_raise_without_gpu(self, monkeypatch, models):
        _, tcfg, m = models
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            tllama.LlamaForCausalLM(tcfg, m["f32"][1])
        with pytest.raises(RuntimeError):
            params_from_numpy({"a": np.zeros(2, np.float32)})
        with pytest.raises(RuntimeError):
            tllama.LlamaForCausalLM.synthetic_q4(tcfg)
