"""Kernel 1 of the port, ``int4_matmul`` (q4_0 dequant-matmul), held
against the JAX package: its plain PyTorch version against the Pallas
kernel run in interpret mode and against ``llama._dequant_q4`` + matmul
(the JAX package's CPU path), on the same seeded numpy inputs. The CUDA
kernel runs only on the card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.llm.ggml.quantize import quantize as j_quantize
from bigdl_tpu.llm.kernels.int4_matmul import int4_matmul as j_int4_matmul
from bigdl_tpu.llm.kernels.int4_matmul import to_tpu_layout as j_layout
from bigdl_tpu.llm.models.llama import _dequant_q4 as j_dequant

from bigdl_tpu_torch.llm.kernels.int4_matmul import (
    dequant_q4, int4_matmul, int4_matmul_reference, quantize_tpu)


def _bf16_exact(a):
    """Round through bf16 so the Pallas kernel's bf16 cast of x is exact
    and both sides see identical inputs."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(seed, m, k, n):
    rs = np.random.RandomState(seed)
    x = _bf16_exact(rs.randn(m, k).astype(np.float32))
    w = (rs.randn(n, k) * 0.1).astype(np.float32)
    td = j_layout(j_quantize(w, "sym_int4"))
    return x, td["q"], td["scale"]


SHAPES = [(1, 64, 48), (5, 96, 40), (17, 256, 132), (3, 128, 256)]


class TestPlainVersion:
    @pytest.mark.parametrize("m,k,n", SHAPES)
    def test_matches_pallas_interpret(self, m, k, n):
        """Tolerance 2e-6 of max|y|: both sum exact f32 products of the
        same bf16 x and f32 weights; only the summation order differs."""
        x, q, s = _inputs(1, m, k, n)
        want = np.asarray(j_int4_matmul(
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), interpret=True,
            out_dtype=jnp.float32), np.float32)
        got = int4_matmul_reference(torch.from_numpy(x), torch.from_numpy(q),
                                    torch.from_numpy(s)).numpy()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale < 2e-6

    @pytest.mark.parametrize("m,k,n", SHAPES)
    def test_matches_jax_dequant_path(self, m, k, n):
        """The JAX package's CPU ``_linear``: ``x @ _dequant_q4(wd)`` in
        f32. Same f32 weights, same products: 2e-6 of max|y|."""
        x, q, s = _inputs(2, m, k, n)
        w = np.asarray(j_dequant({"q": jnp.asarray(q),
                                  "scale": jnp.asarray(s)}, jnp.float32))
        want = x @ w
        got = int4_matmul(torch.from_numpy(x), torch.from_numpy(q),
                          torch.from_numpy(s), out_dtype=torch.float32)
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got.numpy() - want).max() / scale < 2e-6

    @pytest.mark.parametrize("m,k,n", SHAPES[:2])
    def test_dequant_bit_identical(self, m, k, n):
        _, q, s = _inputs(3, m, k, n)
        want = np.asarray(j_dequant({"q": jnp.asarray(q),
                                     "scale": jnp.asarray(s)}, jnp.float32))
        got = dequant_q4(torch.from_numpy(q), torch.from_numpy(s))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_bf16_output_and_quantize_on_tensor(self):
        """bf16 output is the f32 result rounded once; the torch-side
        quantizer feeds the same layout."""
        rs = np.random.RandomState(4)
        x = torch.from_numpy(rs.randn(3, 64).astype(np.float32))
        td = quantize_tpu(torch.from_numpy(rs.randn(40, 64)
                                           .astype(np.float32)))
        y32 = int4_matmul(x, td["q"], td["scale"], out_dtype=torch.float32)
        y16 = int4_matmul(x, td["q"], td["scale"])
        assert y16.dtype == torch.bfloat16
        torch.testing.assert_close(y16, y32.to(torch.bfloat16), rtol=0,
                                   atol=0)

    def test_cpu_dispatch_launches_no_kernel(self):
        x, q, s = _inputs(5, 2, 64, 48)
        before = int4_matmul.launches
        int4_matmul(torch.from_numpy(x), torch.from_numpy(q),
                    torch.from_numpy(s))
        assert int4_matmul.launches == before

    def test_layout_checks(self):
        x, q, s = _inputs(6, 2, 64, 48)
        with pytest.raises(ValueError, match="layout"):
            int4_matmul(torch.from_numpy(x), torch.from_numpy(q.T.copy()),
                        torch.from_numpy(s))
        with pytest.raises(ValueError, match="scale_t"):
            int4_matmul(torch.from_numpy(x), torch.from_numpy(q),
                        torch.from_numpy(s[:1]))

