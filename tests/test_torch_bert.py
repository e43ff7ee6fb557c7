"""The port's DLlib slice — the ``nn`` module contract, the layers BERT is
built of, BERT itself, and nano's ``InferenceOptimizer`` pipelines —
held against the JAX package on ``BertConfig.tiny()``: weights carried
from the JAX model through ``load_parameters_dict``, token ids drawn
with numpy from a seed, everything in f32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.transformers.convert import \
    ggml_convert_low_bit as j_convert
from bigdl_tpu.models import bert as jbert
from bigdl_tpu.nano.inference_optimizer import \
    InferenceOptimizer as JInferenceOptimizer
from bigdl_tpu.nn.layers.activation import GELU as JGELU
from bigdl_tpu.nn.layers.embedding import LookupTable as JLookupTable
from bigdl_tpu.nn.layers.normalization import LayerNorm as JLayerNorm

from bigdl_tpu_torch.llm.transformers import (LowBitLinear,
                                              ggml_convert_low_bit,
                                              optimize_model)
from bigdl_tpu_torch.models import bert as tbert
from bigdl_tpu_torch.nano import InferenceOptimizer
from bigdl_tpu_torch.nn import (GELU, Dropout, LayerNorm, Linear,
                                LookupTable, quantized)
from bigdl_tpu_torch.utils.table import T, Table

PIPELINES = ("int8", "asym_int4", "sym_int4", "quantize_model")


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    """JAX layers built here draw from the JAX package's global init
    stream; put it back so other test files see the draws they expect."""
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _tree(m):
    return jax.tree_util.tree_map(np.asarray, m)


@pytest.fixture
def models():
    """The JAX tiny classifier and the port's, with its weights carried."""
    jm = jbert.build_classifier(jbert.BertConfig.tiny(), 2)
    tm = tbert.build_classifier(tbert.BertConfig.tiny(), 2, device="cpu")
    tm.load_parameters_dict(_tree(jm.parameters_dict()))
    return jm, tm


def _ids(seed=0, shape=(3, 16)):
    return np.random.RandomState(seed).randint(0, 64, shape)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{path}.{k}")
        else:
            np.testing.assert_array_equal(got[k].detach().numpy(), w,
                                          err_msg=f"{path}.{k}")


def _pipelines(jm, tm, name):
    if name == "quantize_model":
        return (JInferenceOptimizer._quantize_convs(jm),
                InferenceOptimizer._quantize_convs(tm, device="cpu"))
    return (JInferenceOptimizer.quantize(jm, name),
            InferenceOptimizer.quantize(tm, name, device="cpu"))


class TestModuleContract:
    def test_trees_carry_key_for_key(self, models):
        jm, tm = models
        _assert_trees_equal(tm.parameters_dict(),
                            _tree(jm.parameters_dict()))
        assert tm.states_dict() == {} == jm.states_dict()
        bert = tm.bert
        assert list(bert._modules)[:3] == ["embeddings", "layer0", "layer1"]
        assert list(bert.layer0.attention._modules) == \
            ["q", "k", "v", "out", "drop"]

    def test_evaluate_is_eval(self, models):
        _, tm = models
        assert tm.is_training()
        assert tm.evaluate() is tm
        assert not any(m.training for m in tm.modules())
        assert not tm.is_training()

    def test_load_keeps_device_and_dtype_of_array(self):
        lin = Linear(4, 3)
        w = np.arange(12, dtype=np.float32).reshape(3, 4)
        lin.load_parameters_dict({"weight": w, "unused": w})
        np.testing.assert_array_equal(lin.weight.detach().numpy(), w)
        assert isinstance(lin.weight, torch.nn.Parameter)
        assert lin.weight.device.type == "cpu"


class TestLayers:
    @pytest.mark.parametrize("approximate", [True, False])
    def test_gelu(self, approximate):
        x = np.random.RandomState(1).randn(4, 9).astype(np.float32) * 3
        want = np.asarray(JGELU(approximate).forward(jnp.asarray(x)))
        got = GELU(approximate)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)

    def test_gelu_default_is_approximate(self):
        assert GELU().approximate and JGELU().approximate

    def test_layer_norm_biased_variance(self):
        jl = JLayerNorm(16, eps=1e-5)
        tl = LayerNorm(16, eps=1e-5)
        p = _tree(jl.parameters_dict())
        p["weight"] = np.linspace(0.5, 1.5, 16).astype(np.float32)
        p["bias"] = np.linspace(-1, 1, 16).astype(np.float32)
        jl.load_parameters_dict(p)
        tl.load_parameters_dict(p)
        x = np.random.RandomState(2).randn(3, 5, 16).astype(np.float32)
        want = np.asarray(jl.forward(jnp.asarray(x)))
        got = tl(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)

    @pytest.mark.parametrize("zero_based", [True, False])
    def test_lookup_table_clips_out_of_range(self, zero_based):
        """Ids below and above the table are clipped, as the JAX layer
        does; ``F.embedding`` alone would raise."""
        jt = JLookupTable(10, 4, zero_based=zero_based, padding_value=3)
        tt = LookupTable(10, 4, zero_based=zero_based, padding_value=3)
        tt.load_parameters_dict(_tree(jt.parameters_dict()))
        ids = np.array([[-5, 0, 1, 3], [9, 10, 11, 400]])
        want = np.asarray(jt.forward(jnp.asarray(ids)))
        got = tt(torch.from_numpy(ids)).detach().numpy()
        np.testing.assert_array_equal(got, want)

    def test_lookup_table_max_norm(self):
        jt = JLookupTable(6, 5, max_norm=1.0, zero_based=True)
        tt = LookupTable(6, 5, max_norm=1.0, zero_based=True)
        tt.load_parameters_dict(_tree(jt.parameters_dict()))
        ids = np.array([0, 2, 5, 5])
        np.testing.assert_allclose(
            tt(torch.from_numpy(ids)).detach().numpy(),
            np.asarray(jt.forward(jnp.asarray(ids))), rtol=0, atol=1e-6)

    def test_dropout(self):
        """Identity in eval mode; in train mode an inverted-dropout mask
        from the module's explicit generator (the same seed gives the
        same mask), kept values scaled by 1/keep."""
        x = torch.ones(64, 64)
        d = Dropout(0.25, generator=torch.Generator().manual_seed(5))
        assert d.eval()(x) is x
        y = d.train()(x)
        kept = (x / 0.75)[0, 0].item()
        assert set(torch.unique(y).tolist()) <= {0.0, kept}
        assert 0.15 < (y == 0).float().mean().item() < 0.35
        again = Dropout(0.25, generator=torch.Generator().manual_seed(5))
        assert torch.equal(again.train()(x), y)
        named = Dropout(0.25, name="drop_x")
        assert torch.equal(named.train()(x),
                           Dropout(0.25, name="drop_x").train()(x))

    def test_table(self):
        t = T("a", "b", key="c")
        assert t[1] == "a" and t[2] == "b" and t["key"] == "c"
        assert t.to_list() == ["a", "b", "c"] and len(t) == 3
        assert Table(torch.ones(2)) == Table(np.ones(2))
        assert t.insert("d")[4] == "d"


class TestBert:
    def test_float_forward_matches_jax(self, models):
        """Log-probs within 1e-4 (f32 on both sides; the order of
        summation differs)."""
        jm, tm = models
        ids = _ids()
        want = np.asarray(JInferenceOptimizer.trace(jm).forward(ids))
        got = InferenceOptimizer.trace(tm, device="cpu").forward(ids)
        assert isinstance(got, np.ndarray) and got.shape == (3, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def test_masked_input_matches_jax(self, models):
        """(ids, segment ids, mask) input, one row with an all-zero mask:
        uniform attention weights there, as in the JAX layer (SDPA would
        give NaN)."""
        jm, tm = models
        ids = _ids(1, (3, 12))
        segs = np.zeros_like(ids)
        segs[:, 6:] = 1
        mask = np.ones_like(ids)
        mask[1, 8:] = 0
        mask[2] = 0
        jm.evaluate()
        want = np.asarray(jm.forward(
            (jnp.asarray(ids), jnp.asarray(segs), jnp.asarray(mask))))
        with torch.inference_mode():
            got = tm.evaluate()(tuple(torch.from_numpy(a)
                                      for a in (ids, segs, mask))).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def test_bert_model_output_table(self, models):
        jm, tm = models
        ids = _ids(2, (2, 8))
        jout = jm._modules["bert"].evaluate().forward(jnp.asarray(ids))
        with torch.inference_mode():
            tout = tm.bert.evaluate()(torch.from_numpy(ids))
        assert isinstance(tout, Table) and set(tout.keys()) == \
            {"output", "pooled"}
        for k in ("output", "pooled"):
            np.testing.assert_allclose(tout[k].numpy(),
                                       np.asarray(jout[k]), rtol=0,
                                       atol=1e-5)

    @pytest.mark.parametrize("name", PIPELINES)
    def test_quantized_pipeline_matches_jax(self, models, name):
        """Each low-bit pipeline: the quantized states both sides make
        from the same float weights are identical, there is one
        quantized module per Linear (6 per layer + pooler + classifier),
        and the log-probs agree within 1e-4 (f32 dequant-matmuls on both
        sides; summation order differs)."""
        jm, tm = models
        jc, tc = _pipelines(jm, tm, name)
        _assert_trees_equal(tc._model.states_dict(),
                            _tree(jc._model.states_dict()))
        kind = quantized.Linear if name == "quantize_model" else \
            LowBitLinear
        assert sum(isinstance(m, kind) for m in tc._model.modules()) == 14
        assert not any(type(m) is Linear for m in tc._model.modules())
        assert not tc._model.training
        ids = _ids(3)
        want = np.asarray(jc.forward(ids))
        got = tc.forward(ids)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        # the user's float model is untouched
        assert sum(isinstance(m, Linear) for m in tm.modules()) == 14

    def test_modules_to_not_convert(self, models):
        jm, tm = models
        jq = j_convert(jm, "asym_int4", modules_to_not_convert=["classifier"])
        tq = optimize_model(tm, "asym_int4",
                            modules_to_not_convert=["classifier"])
        assert tq is tm
        assert type(tq.classifier) is Linear
        assert sum(isinstance(m, LowBitLinear) for m in tq.modules()) == 13
        other = tbert.build_classifier(tbert.BertConfig.tiny(), 2,
                                       device="cpu")
        by_name = ggml_convert_low_bit(
            other, "sym_int8", modules_to_not_convert=[other.bert.pooler.name])
        assert type(by_name.bert.pooler) is Linear
        assert sum(isinstance(m, LowBitLinear)
                   for m in by_name.modules()) == 13
        jq.evaluate()
        tq.evaluate()
        ids = _ids(4)
        with torch.inference_mode():
            got = tq(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, np.asarray(jq.forward(
            jnp.asarray(ids))), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("precision", ["bf16", "fp16"])
    def test_half_precision_pipeline(self, models, precision):
        """Float params cast to bf16/fp16 on both sides. The two
        frameworks round activations at different points, so the bound
        is 3e-2 on the log-probs (measured 6e-3 in bf16, 1e-3 in fp16)."""
        jm, tm = models
        ids = _ids(5)
        tc = InferenceOptimizer.quantize(tm, precision, device="cpu")
        assert all(p.dtype != torch.float32
                   for p in tc._model.parameters())
        assert tm.classifier.weight.dtype == torch.float32
        want = np.asarray(JInferenceOptimizer.quantize(jm, precision)
                          .forward(ids), np.float32)
        np.testing.assert_allclose(tc.forward(ids), want, rtol=0, atol=3e-2)

    def test_unsupported_precision_raises(self, models):
        """nf4, once refused, runs as the JAX pipeline does (logits within
        3e-2); a precision the JAX package does not know raises its
        ValueError on both sides."""
        jm, tm = models
        ids = _ids(6)
        want = np.asarray(JInferenceOptimizer.quantize(jm, "nf4")
                          .forward(ids), np.float32)
        got = InferenceOptimizer.quantize(tm, "nf4", device="cpu")
        np.testing.assert_allclose(got.forward(ids), want, rtol=0,
                                   atol=3e-2)
        with pytest.raises(ValueError, match="unknown qtype"):
            JInferenceOptimizer.quantize(jm, "int3")
        with pytest.raises(ValueError, match="unknown qtype"):
            InferenceOptimizer.quantize(tm, "int3", device="cpu")

    def test_default_device_is_the_gpu(self, models, monkeypatch):
        """``device=None`` means the card; without one the entry points
        raise instead of running on the CPU."""
        _, tm = models
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbert.build_classifier(tbert.BertConfig.tiny(), 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceOptimizer.quantize(tm, "int8")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceOptimizer.trace(tm)
