"""Every ggml qtype of the port (``ggml_qtypes()``: the kernel formats and
``sym_int5``, ``nf4``, ``fp4``, ``fp8``, ``bf16``) and the native C++
quantizer, held against the JAX package on the CPU: the same numpy
weights through both, no tolerance on what is quantized; ``LowBitLinear``
states equal and f32 forward within 1e-5 of max|y|; nano ``quantize`` on
the tiny BERT within 3e-2 of the JAX logits."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import native as jnative
from bigdl_tpu.llm.ggml.quantize import dequantize as j_dequantize
from bigdl_tpu.llm.ggml.quantize import quantize as j_quantize
from bigdl_tpu.llm.kernels.int4_matmul import to_tpu_layout as j_layout
from bigdl_tpu.llm.transformers.convert import \
    ggml_convert_low_bit as j_convert
from bigdl_tpu.llm.transformers.low_bit_linear import \
    LowBitLinear as JLowBitLinear
from bigdl_tpu.models import bert as jbert
from bigdl_tpu.nano.inference_optimizer import \
    InferenceOptimizer as JInferenceOptimizer
from bigdl_tpu.nn.layers.linear import Linear as JLinear

from bigdl_tpu_torch import native
from bigdl_tpu_torch.llm.ggml.quantize import (CAST_QTYPES, dequantize,
                                               ggml_qtypes, quantize,
                                               quantize_numpy,
                                               quantize_torch)
from bigdl_tpu_torch.llm.kernels.int4_matmul import (quantize_tpu,
                                                     to_tpu_layout)
from bigdl_tpu_torch.llm.transformers import (LowBitLinear,
                                              ggml_convert_low_bit)
from bigdl_tpu_torch.models import bert as tbert
from bigdl_tpu_torch.nano import InferenceOptimizer
from bigdl_tpu_torch.nn import Linear, Module

NEW = ("sym_int5", "nf4", "fp4", "fp8", "bf16")


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _edge_weights(qtype, n=40, k=128, seed=0):
    """Random rows plus the edges: an all-zero block, a block whose fp16
    scale underflows, a row of -0.0 (fp4's tie of 0.0 and -0.0), f32
    subnormals, values at and past e4m3fn's 448 (the tie at 464, 480,
    1e5) and e4m3fn's own subnormals; ±inf for the casts only."""
    rs = np.random.RandomState(seed)
    w = (rs.randn(n, k) * rs.uniform(0.01, 2.0, (n, 1))).astype(np.float32)
    w[0, :32] = 0.0
    w[1, 32:64] = 1e-9
    w[2] = -0.0
    w[3, :32] = 1e-40 * rs.randn(32)
    w[4, :10] = [448, 449, 463.9, 464, -464, 464.1, 480, -1e5, 2 ** -9,
                 3 * 2 ** -11]
    w[5, 3:35] = (np.arange(32) - 16) * 2.0 ** -8   # ties of every grid
    if qtype in CAST_QTYPES:
        w[6, :2] = [np.inf, -np.inf]
    return w


def _bits(a):
    """Any plane as comparable numpy bits (bf16 / e4m3fn as uint)."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            return _bits(np.array(a.view(torch.int16 if a.element_size()
                                         == 2 else torch.uint8)))
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint8) \
        if a.dtype.name in ("bfloat16", "float8_e4m3fn", "int16") else a


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k != "qtype":
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                          err_msg=k)
    assert got["qtype"] == want["qtype"]


@pytest.mark.parametrize("qtype", ggml_qtypes())
def test_quantize_bit_equal(qtype):
    """numpy, torch and the kernel layout equal the JAX package's dicts
    bit for bit, and so do the dequantized weights."""
    w = _edge_weights(qtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # fp16 overflow
        want = j_quantize(w, qtype)
        got = quantize(w, qtype)
        _assert_dicts_equal(got, want)
        _assert_dicts_equal(quantize_numpy(w, qtype), want)
        _assert_dicts_equal(quantize_torch(torch.from_numpy(w), qtype), want)
        np.testing.assert_array_equal(dequantize(got), j_dequantize(want))
        _assert_dicts_equal(to_tpu_layout(got), j_layout(want))
        _assert_dicts_equal(quantize_tpu(w, qtype), j_layout(want))


def test_unknown_qtype_raises_value_error():
    w = np.ones((2, 32), np.float32)
    for fn in (j_quantize, quantize, lambda w, q: quantize_torch(
            torch.from_numpy(w), q)):
        with pytest.raises(ValueError, match="unknown qtype"):
            fn(w, "int3")


def test_to_tpu_layout_passes_other_formats_through():
    """The formats without a kernel keep the row-major dict, as the JAX
    package's ``to_tpu_layout`` returns it (the parent raised)."""
    w = _edge_weights("nf4", seed=1)
    for qtype in NEW:
        qd = quantize(w, qtype)
        out = to_tpu_layout(qd)
        assert out is not qd and set(out) == set(qd)
        assert all(out[k] is qd[k] for k in qd)


def test_native_bit_equal_to_jax_native():
    """The port's build of ``quant.cpp`` against the JAX package's, call
    for call, and against the port's numpy path (``g++`` is here, so
    neither may fall back)."""
    rs = np.random.RandomState(2)
    w = rs.randn(96, 256).astype(np.float32)
    w[0, :32] = 0.0
    assert native.available() and jnative.available()
    for fn, qtype in (("native_quantize_q4_0", "sym_int4"),
                      ("native_quantize_q8_0", "sym_int8")):
        got = getattr(native, fn)(w)
        _assert_dicts_equal(got, getattr(jnative, fn)(w))
        _assert_dicts_equal(got, quantize_numpy(w, qtype))
    q = native.native_quantize_q4_0(w)
    np.testing.assert_array_equal(
        native.native_dequantize_q4_0(q["q"], q["scale"]),
        jnative.native_dequantize_q4_0(q["q"], q["scale"]))
    x = rs.randn(5, 256).astype(np.float32)
    np.testing.assert_array_equal(
        native.native_matmul_q4_0(x, q["q"], q["scale"]),
        jnative.native_matmul_q4_0(x, q["q"], q["scale"]))
    assert native.native_quantize_q4_0(w[:, :40]) is None


@pytest.mark.parametrize("qtype", NEW)
def test_low_bit_linear_matches_jax(qtype):
    """from_linear makes the JAX states; states carried from the JAX
    module load as they are; f32 forward within 1e-5 of max|y|."""
    jl = JLinear(96, 40)
    tl = Linear(96, 40, name=jl.name)
    tl.load_parameters_dict(jax.tree_util.tree_map(
        np.asarray, jl.parameters_dict()))
    jm, tm = JLowBitLinear.from_linear(jl, qtype), \
        LowBitLinear.from_linear(tl, qtype)
    want = jax.tree_util.tree_map(np.asarray, jm.states_dict())
    _assert_dicts_equal(dict(tm.states_dict(), qtype=qtype),
                        dict(want, qtype=qtype))
    x = np.random.RandomState(3).randn(2, 3, 96).astype(np.float32)
    y = np.asarray(jm.forward(jnp.asarray(x)))
    other = LowBitLinear.from_weight(np.zeros((40, 96), np.float32), qtype,
                                     bias=torch.zeros(40))
    other.load_states_dict(want)
    other.load_parameters_dict({"bias": np.asarray(jm._params["bias"])})
    for m in (tm, other):
        with torch.inference_mode():
            got = m(torch.from_numpy(x)).numpy()
        assert got.shape == y.shape
        np.testing.assert_allclose(got, y, rtol=0,
                                   atol=1e-5 * np.abs(y).max())


def _holding(linear):
    holder = Module()
    holder.add_module("fc", linear)
    return holder


@pytest.mark.parametrize("qtype", ("bf16", "fp8"))
def test_cast_formats_convert_any_in_features(qtype):
    """bf16 / fp8 have no blocks: a Linear with in_features % 32 != 0 is
    converted, as in the JAX package (the parent kept it float); a block
    format keeps it float."""
    jl = JLinear(40, 8)
    tl = Linear(40, 8, name=jl.name)
    tl.load_parameters_dict(jax.tree_util.tree_map(
        np.asarray, jl.parameters_dict()))
    low = ggml_convert_low_bit(_holding(tl), qtype).fc
    assert isinstance(low, LowBitLinear) and low.qtype == qtype
    assert type(ggml_convert_low_bit(_holding(Linear(40, 8)), "nf4").fc) \
        is Linear
    x = np.random.RandomState(4).randn(3, 40).astype(np.float32)
    with torch.inference_mode():
        got = low(torch.from_numpy(x)).numpy()
    y = np.asarray(JLowBitLinear.from_linear(jl, qtype).forward(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, y, rtol=0, atol=1e-5 * np.abs(y).max())


@pytest.fixture(scope="module")
def bert_models():
    jm = jbert.build_classifier(jbert.BertConfig.tiny(), 2)
    tm = tbert.build_classifier(tbert.BertConfig.tiny(), 2, device="cpu")
    tm.load_parameters_dict(jax.tree_util.tree_map(
        np.asarray, jm.parameters_dict()))
    return jm, tm


@pytest.mark.parametrize("precision", ("sym_int5", "nf4", "fp4", "fp8"))
def test_nano_quantize_bert_matches_jax(bert_models, precision):
    """nano ``quantize`` at each new precision: every Linear a
    LowBitLinear of it, logits within 3e-2 of the JAX pipeline's."""
    jm, tm = bert_models
    ids = np.random.RandomState(5).randint(0, 64, (3, 16))
    tc = InferenceOptimizer.quantize(tm, precision, device="cpu")
    lows = [m for m in tc._model.modules() if isinstance(m, LowBitLinear)]
    assert len(lows) == 14 and {m.qtype for m in lows} == {precision}
    want = np.asarray(JInferenceOptimizer.quantize(jm, precision)
                      .forward(ids), np.float32)
    np.testing.assert_allclose(tc.forward(ids), want, rtol=0, atol=3e-2)


def test_optimize_model_bf16_bert_matches_jax(bert_models):
    """``optimize_model(low_bit="bf16")`` (LowBitLinear bf16, unlike nano's
    ``"bf16"`` cast) on copies of the tiny BERT."""
    import copy
    jm, tm = bert_models
    jq = j_convert(copy.deepcopy(jm), "bf16")
    tq = ggml_convert_low_bit(copy.deepcopy(tm), "bf16")
    ids = np.random.RandomState(6).randint(0, 64, (2, 16))
    jq.evaluate()
    tq.evaluate()
    with torch.inference_mode():
        got = tq(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.forward(jnp.asarray(ids))),
                               rtol=0, atol=3e-2)
