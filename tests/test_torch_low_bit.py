"""Kernels 4 and 5 of the port, ``asym_int4_matmul`` (q4_1) and
``int8_matmul`` (q8_0), and the low-bit modules that run them
(``LowBitLinear``, ``nn.quantized.Linear``), held against the JAX package
on the same seeded numpy inputs:

- quantization and the k-major layout bit for bit;
- each kernel's plain PyTorch version against the Pallas kernel run in
  interpret mode (f32 out);
- the modules on the same carried states, in f32.

The CUDA kernels run only on the card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.ggml.quantize import dequantize as j_dequantize
from bigdl_tpu.llm.ggml.quantize import quantize as j_quantize
from bigdl_tpu.llm.kernels.int4_matmul import \
    asym_int4_matmul as j_asym_int4_matmul
from bigdl_tpu.llm.kernels.int4_matmul import int8_matmul as j_int8_matmul
from bigdl_tpu.llm.kernels.int4_matmul import to_tpu_layout as j_layout
from bigdl_tpu.llm.transformers.low_bit_linear import \
    LowBitLinear as JLowBitLinear
from bigdl_tpu.nn.layers.linear import Linear as JLinear
from bigdl_tpu.nn import quantized as jquantized

from bigdl_tpu_torch.llm.ggml.quantize import (QK, dequantize, quantize,
                                               quantize_torch)
from bigdl_tpu_torch.llm.kernels import launch_counts
from bigdl_tpu_torch.llm.kernels.int4_matmul import (
    asym_int4_matmul, dequant_q4, dequant_q4_1, dequant_q8_0, int8_matmul,
    quantize_tpu, to_tpu_layout)
from bigdl_tpu_torch.llm.transformers.low_bit_linear import LowBitLinear
from bigdl_tpu_torch.nn import quantized
from bigdl_tpu_torch.nn.layers.linear import Linear

QTYPES = ("sym_int4", "asym_int4", "sym_int8")


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    """JAX layers built here draw from the JAX package's global init
    stream; put it back so other test files see the draws they expect."""
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _weights(seed, n, k, zero_block=False):
    rs = np.random.RandomState(seed)
    w = (rs.randn(n, k) * rs.uniform(0.01, 2.0, (n, 1)) + 0.05) \
        .astype(np.float32)
    if zero_block:
        w[0, :QK] = 0.0          # an all-zero block: scale 0
        w[1, QK:2 * QK] = 1e-9   # a tiny block: fp16 scale underflow
    return w


def _bf16_exact(a):
    """Round through bf16 so the Pallas kernels' bf16 cast of x is exact
    and both sides see identical inputs."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        assert _np(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)


SHAPES = [(8, 32, False), (48, 64, True), (130, 256, True)]


class TestQuantize:
    """No tolerance: the arithmetic (f32 division, fp16 scale and zero
    rounding, half-to-even rounding) is the same, so any difference is a
    bug. ``sym_int8`` on the JAX side goes through its native quantizer
    where that is built; the port must match whatever it returns."""

    @pytest.mark.parametrize("qtype", ["asym_int4", "sym_int8"])
    @pytest.mark.parametrize("n,k,zb", SHAPES)
    def test_numpy_and_torch_bit_identical(self, qtype, n, k, zb):
        w = _weights(0, n, k, zb)
        want = j_quantize(w, qtype)
        _assert_same_tree(quantize(w, qtype), want)
        _assert_same_tree(quantize_torch(torch.from_numpy(w), qtype), want)

    @pytest.mark.parametrize("qtype", ["asym_int4", "sym_int8"])
    @pytest.mark.parametrize("n,k,zb", SHAPES)
    def test_kernel_layout_bit_identical(self, qtype, n, k, zb):
        w = _weights(1, n, k, zb)
        want = j_layout(j_quantize(w, qtype))
        for got in (to_tpu_layout(quantize(w, qtype)),
                    quantize_tpu(w, qtype),
                    quantize_tpu(torch.from_numpy(w), qtype)):
            _assert_same_tree(got, want)
            assert got["scale"].dtype in (np.float32, torch.float32)

    @pytest.mark.parametrize("qtype", ["asym_int4", "sym_int8"])
    def test_dequantize_equal(self, qtype):
        w = _weights(2, 48, 64, True)
        np.testing.assert_array_equal(dequantize(quantize(w, qtype)),
                                      j_dequantize(j_quantize(w, qtype)))

    @pytest.mark.parametrize("qtype", QTYPES)
    def test_kernel_dequant_bit_identical(self, qtype):
        """The k-major dequant of the plain versions equals the JAX
        package's ``LowBitLinear._dequant`` (its XLA path) bit for bit."""
        jm = JLowBitLinear.from_weight(_weights(3, 40, 96), qtype)
        want = np.asarray(jm._dequant(jm._states, jnp.float32))
        st = {k: torch.from_numpy(np.array(v)) for k, v in
              jm._states.items()}
        fn = {"sym_int4": dequant_q4, "asym_int4": dequant_q4_1,
              "sym_int8": dequant_q8_0}[qtype]
        got = fn(*[st[k] for k in ("q", "scale", "zero") if k in st])
        np.testing.assert_array_equal(got.numpy(), want)


def _kernel_inputs(seed, qtype, m, k, n):
    rs = np.random.RandomState(seed)
    x = _bf16_exact(rs.randn(m, k).astype(np.float32))
    w = (rs.randn(n, k) * 0.1 + 0.02).astype(np.float32)
    return x, j_layout(j_quantize(w, qtype))


KSHAPES = [(1, 64, 2), (5, 96, 40), (17, 256, 128), (3, 128, 3)]


class TestKernels:
    @pytest.mark.parametrize("m,k,n", KSHAPES)
    def test_asym_int4_matches_pallas_interpret(self, m, k, n):
        """Tolerance 1e-5 of max|y|: both sum f32 products of the same
        bf16 x and f32 dequantized weights; the order differs."""
        x, td = _kernel_inputs(1, "asym_int4", m, k, n)
        want = np.asarray(j_asym_int4_matmul(
            jnp.asarray(x), jnp.asarray(td["q"]), jnp.asarray(td["scale"]),
            jnp.asarray(td["zero"]), interpret=True,
            out_dtype=jnp.float32), np.float32)
        got = asym_int4_matmul(torch.from_numpy(x),
                               torch.from_numpy(td["q"]),
                               torch.from_numpy(td["scale"]),
                               torch.from_numpy(td["zero"]),
                               out_dtype=torch.float32).numpy()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale < 1e-5

    @pytest.mark.parametrize("m,k,n", KSHAPES)
    def test_int8_matches_pallas_interpret(self, m, k, n):
        """Tolerance 1e-5 of max|y|, as above."""
        x, td = _kernel_inputs(2, "sym_int8", m, k, n)
        want = np.asarray(j_int8_matmul(
            jnp.asarray(x), jnp.asarray(td["q"]), jnp.asarray(td["scale"]),
            interpret=True, out_dtype=jnp.float32), np.float32)
        got = int8_matmul(torch.from_numpy(x), torch.from_numpy(td["q"]),
                          torch.from_numpy(td["scale"]),
                          out_dtype=torch.float32).numpy()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale < 1e-5

    @pytest.mark.parametrize("qtype", ["asym_int4", "sym_int8"])
    def test_bf16_output_is_f32_rounded_once(self, qtype):
        x, td = _kernel_inputs(3, qtype, 4, 64, 24)
        args = [torch.from_numpy(td[k]) for k in ("q", "scale", "zero")
                if k in td]
        fn = asym_int4_matmul if qtype == "asym_int4" else int8_matmul
        y32 = fn(torch.from_numpy(x), *args, out_dtype=torch.float32)
        y16 = fn(torch.from_numpy(x), *args)
        assert y16.dtype == torch.bfloat16
        torch.testing.assert_close(y16, y32.to(torch.bfloat16), rtol=0,
                                   atol=0)

    def test_broadcast_scale_equals_materialised(self):
        """A per-channel scale expanded over the groups (stride 0, as
        ``nn.quantized.Linear`` passes it) gives what a copied (K/32, N)
        scale gives."""
        rs = np.random.RandomState(4)
        x = torch.from_numpy(rs.randn(3, 64).astype(np.float32))
        q = torch.from_numpy(rs.randint(-127, 128, (64, 10)).astype(
            np.int8))
        s = torch.from_numpy(rs.uniform(0.01, 0.1, 10).astype(np.float32))
        view = s[None, :].expand(2, 10)
        assert view.stride(0) == 0
        torch.testing.assert_close(int8_matmul(x, q, view),
                                   int8_matmul(x, q, view.contiguous()),
                                   rtol=0, atol=0)

    def test_cpu_dispatch_launches_no_kernel(self):
        x, td = _kernel_inputs(5, "asym_int4", 2, 64, 8)
        before = launch_counts()
        asym_int4_matmul(torch.from_numpy(x), torch.from_numpy(td["q"]),
                         torch.from_numpy(td["scale"]),
                         torch.from_numpy(td["zero"]))
        x8, t8 = _kernel_inputs(5, "sym_int8", 2, 64, 8)
        int8_matmul(torch.from_numpy(x8), torch.from_numpy(t8["q"]),
                    torch.from_numpy(t8["scale"]))
        assert launch_counts() == before

    def test_layout_checks(self):
        x, td = _kernel_inputs(6, "sym_int8", 2, 64, 8)
        x, q, s = (torch.from_numpy(a) for a in (x, td["q"], td["scale"]))
        with pytest.raises(ValueError, match="layout"):
            int8_matmul(x, q.t().contiguous(), s)
        with pytest.raises(ValueError, match="scale_t"):
            int8_matmul(x, q, s[:1])
        with pytest.raises(ValueError, match="multiple of 32"):
            asym_int4_matmul(x[:, :40], q[:20], s, s)


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class TestLowBitLinear:
    @pytest.mark.parametrize("qtype", QTYPES)
    @pytest.mark.parametrize("n,k", [(40, 96), (2, 64), (130, 256)])
    def test_forward_matches_jax_on_carried_states(self, qtype, n, k):
        """f32 in and out on both sides (the JAX package's CPU path is
        its XLA dequant-matmul): 1e-5 of max|y|."""
        w = _weights(7, n, k)
        b = _x(8, (n,))
        jm = JLowBitLinear.from_weight(w, qtype, bias=b)
        tm = LowBitLinear.from_weight(w, qtype, bias=b)
        jstates = jax.tree_util.tree_map(np.asarray, jm.states_dict())
        _assert_same_tree(tm.states_dict(), jstates)
        tm.load_states_dict(jstates)             # the weight carry
        x = _x(9, (2, 3, k))
        want = np.asarray(jm.forward(jnp.asarray(x)))
        got = tm(torch.from_numpy(x))
        assert tuple(got.shape) == (2, 3, n) and got.dtype == torch.float32
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got.detach().numpy() - want).max() / scale < 1e-5

    @pytest.mark.parametrize("qtype", QTYPES)
    def test_from_linear_matches_jax(self, qtype):
        """The port's from_linear on weights carried from a JAX Linear
        makes the JAX package's states, keeps its name, and quantizes on
        the weight's device with the torch quantizer."""
        jl = JLinear(64, 24)
        tl = Linear(64, 24, name=jl.name)
        tl.load_parameters_dict(jax.tree_util.tree_map(
            np.asarray, jl.parameters_dict()))
        jm, tm = JLowBitLinear.from_linear(jl, qtype), \
            LowBitLinear.from_linear(tl, qtype)
        assert tm.name == jm.name == jl.name and tm.with_bias
        _assert_same_tree(tm.states_dict(),
                          jax.tree_util.tree_map(np.asarray,
                                                 jm.states_dict()))
        np.testing.assert_array_equal(tm.bias.detach().numpy(),
                                      np.asarray(jm._params["bias"]))

    def test_unsupported_qtype_raises(self):
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            LowBitLinear(64, 8, "nf4")
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            LowBitLinear.from_weight(_weights(10, 8, 64), "fp4")


class TestQuantizedLinear:
    @pytest.mark.parametrize("k", [64, 40])
    def test_matches_jax(self, k):
        """States bit-identical; f32 forward within 1e-5 of max|y|.
        K = 64 goes through ``int8_matmul`` with the scale broadcast to
        (K/32, N); K = 40 computes outside the kernel, as the JAX package
        does on every backend."""
        jl = JLinear(k, 24)
        tl = Linear(k, 24)
        tl.load_parameters_dict(jax.tree_util.tree_map(
            np.asarray, jl.parameters_dict()))
        jq = jquantized.Linear.from_float(jl)
        tq = quantized.Linear.from_float(tl)
        _assert_same_tree(tq.states_dict(),
                          jax.tree_util.tree_map(np.asarray,
                                                 jq.states_dict()))
        assert tq.q.dtype == torch.int8 and tuple(tq.q.shape) == (k, 24)
        x = _x(11, (5, k))
        want = np.asarray(jq.forward(jnp.asarray(x)))
        got = tq(torch.from_numpy(x)).detach().numpy()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale < 1e-5

    def test_zero_row_scale(self):
        """An all-zero output channel quantizes to q = 0, scale = 0, as
        in the JAX package (no division by zero)."""
        jl = JLinear(32, 4)
        p = jax.tree_util.tree_map(np.asarray, jl.parameters_dict())
        p["weight"] = p["weight"].copy()
        p["weight"][2] = 0.0
        jl.load_parameters_dict(p)
        tl = Linear(32, 4)
        tl.load_parameters_dict(p)
        _assert_same_tree(
            quantized.Linear.from_float(tl).states_dict(),
            jax.tree_util.tree_map(np.asarray, jquantized.Linear
                                   .from_float(jl).states_dict()))
