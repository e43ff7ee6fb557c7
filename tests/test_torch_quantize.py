"""q4_0 quantization in the PyTorch port (bigdl_tpu_torch.llm.ggml) held
bit for bit against the JAX package's: the same numpy weights go through
both, and ``q``/``scale`` must be identical — the port's numpy path, its
torch path and the k-major kernel layout alike. No tolerance: the
arithmetic (f32 division, fp16 scale rounding, half-to-even rounding) is
the same, so any difference is a bug."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.llm.ggml.quantize import dequantize as j_dequantize
from bigdl_tpu.llm.ggml.quantize import quantize as j_quantize
from bigdl_tpu.llm.kernels.int4_matmul import to_tpu_layout as j_layout
from bigdl_tpu.llm.models import llama as jllama

from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.ggml.quantize import (
    QK, _pack_nibbles, _unpack_nibbles, dequantize, quantize,
    quantize_torch)
from bigdl_tpu_torch.llm.kernels.int4_matmul import (quantize_tpu,
                                                     to_tpu_layout)
from bigdl_tpu_torch.llm.models import llama as tllama


def _weights(seed, n, k, zero_block=False):
    rs = np.random.RandomState(seed)
    w = (rs.randn(n, k) * rs.uniform(0.01, 2.0, (n, 1))).astype(np.float32)
    if zero_block:
        w[0, :QK] = 0.0          # an all-zero block: scale 0, q == 8
        w[1, QK:2 * QK] = 1e-9   # a tiny block: fp16 scale underflow
    return w


SHAPES = [(8, 32, False), (48, 64, True), (130, 256, True)]


class TestQuantize:
    @pytest.mark.parametrize("n,k,zb", SHAPES)
    def test_numpy_bit_identical(self, n, k, zb):
        w = _weights(0, n, k, zb)
        got, want = quantize(w), j_quantize(w, "sym_int4")
        assert got["q"].dtype == np.uint8 and got["scale"].dtype == \
            np.float16
        np.testing.assert_array_equal(got["q"], want["q"])
        np.testing.assert_array_equal(got["scale"], want["scale"])

    @pytest.mark.parametrize("n,k,zb", SHAPES)
    def test_torch_bit_identical(self, n, k, zb):
        w = _weights(1, n, k, zb)
        got, want = quantize_torch(torch.from_numpy(w)), \
            j_quantize(w, "sym_int4")
        np.testing.assert_array_equal(got["q"].numpy(), want["q"])
        np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])

    @pytest.mark.parametrize("n,k,zb", SHAPES)
    def test_dequantize_equal(self, n, k, zb):
        w = _weights(2, n, k, zb)
        qd = quantize(w)
        np.testing.assert_array_equal(
            dequantize(qd), j_dequantize(j_quantize(w, "sym_int4")))

    def test_plane_split_packing(self):
        """Low nibble = even k, high nibble = odd k, and the unpack is
        the exact inverse."""
        q = np.arange(16, dtype=np.uint8)[None].repeat(3, 0)
        packed = _pack_nibbles(q)
        assert packed[0, 0] == 0 | (1 << 4)
        np.testing.assert_array_equal(_unpack_nibbles(packed), q)

    def test_unsupported_qtype_raises(self):
        """nf4, once refused, quantizes as the JAX package does; an
        unknown qtype and K % 32 != 0 raise its ValueError."""
        w = _weights(4, 8, 64, True)
        got, want = quantize(w, "nf4"), j_quantize(w, "nf4")
        np.testing.assert_array_equal(got["q"], want["q"])
        np.testing.assert_array_equal(got["scale"], want["scale"])
        for q in (quantize, j_quantize):
            with pytest.raises(ValueError, match="unknown qtype"):
                q(np.zeros((2, QK), np.float32), "int3")
        with pytest.raises(ValueError):
            quantize(np.zeros((2, 33), np.float32))


class TestKernelLayout:
    @pytest.mark.parametrize("n,k,zb", SHAPES)
    def test_to_tpu_layout_identical(self, n, k, zb):
        w = _weights(3, n, k, zb)
        want = j_layout(j_quantize(w, "sym_int4"))
        for got in (to_tpu_layout(quantize(w)), quantize_tpu(w)):
            np.testing.assert_array_equal(got["q"], want["q"])
            np.testing.assert_array_equal(got["scale"], want["scale"])
            assert got["scale"].dtype == np.float32

    def test_torch_layout_identical(self):
        w = _weights(4, 64, 128, True)
        want = j_layout(j_quantize(w, "sym_int4"))
        got = quantize_tpu(torch.from_numpy(w))
        assert got["q"].is_contiguous() and got["scale"].is_contiguous()
        np.testing.assert_array_equal(got["q"].numpy(), want["q"])
        np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])

    def test_quantize_params_identical(self):
        """The port's quantize_params (torch, fused) on the JAX package's
        f32 init weights gives the JAX package's quantized tree."""
        cfg = jllama.LlamaConfig.tiny()
        dense = jllama.init_params(cfg, 0, dtype=jnp.float32)
        want = jax.tree_util.tree_map(
            np.asarray, jllama.quantize_params(dense, "sym_int4"))
        got = tllama.quantize_params(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, dense), "cpu"))
        assert set(got["layers"]) == set(want["layers"])
        for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
            for key in ("q", "scale"):
                np.testing.assert_array_equal(
                    got["layers"][name][key].numpy(),
                    want["layers"][name][key], err_msg=f"{name}.{key}")
