"""Kernel 1 of the port, ``int4_matmul`` (q4_0 dequant-matmul), held
against the JAX package: its plain PyTorch version against the Pallas
kernel run in interpret mode and against ``llama._dequant_q4`` + matmul
(the JAX package's CPU path), on the same seeded numpy inputs; the CUDA
kernels' group-scaled algebra (``int4_matmul_grouped``) against the same;
and the shape rule that picks the tensor-core GEMM or the GEMV.
The CUDA kernels run only on the card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.llm.ggml.quantize import quantize as j_quantize
from bigdl_tpu.llm.kernels.int4_matmul import int4_matmul as j_int4_matmul
from bigdl_tpu.llm.kernels.int4_matmul import (
    int4_matmul_reference as j_int4_ref)
from bigdl_tpu.llm.kernels.int4_matmul import to_tpu_layout as j_layout
from bigdl_tpu.llm.models.llama import _dequant_q4 as j_dequant

from bigdl_tpu_torch.llm.kernels.int4_matmul import (
    TC_MIN_M, TC_SMS, dequant_q4, int4_matmul, int4_matmul_grouped,
    int4_matmul_reference, matmul_route, quantize_tpu, tc_block_shape)


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



GROUP_SHAPES = SHAPES + [(3, 14336, 32)]     # 448 groups, Mistral's down


class TestGroupedAlgebra:
    """``int4_matmul_grouped``: the algebra both CUDA kernels run — an
    exact f32 partial ``x_g @ (q_g - 8)`` per 32-row group, then
    ``acc += s_g * partial`` in group order — against the JAX package."""

    @pytest.mark.parametrize("m,k,n", GROUP_SHAPES)
    def test_matches_jax_reference(self, m, k, n):
        """Against ``int4_matmul_reference`` (numpy dequant of the ggml
        layout, f32 matmul): 1e-5 of max|y| (f32 sums in another order)."""
        rs = np.random.RandomState(7)
        x = _bf16_exact(rs.randn(m, k).astype(np.float32))
        qd = j_quantize((rs.randn(n, k) * 0.1).astype(np.float32),
                        "sym_int4")
        td = j_layout(qd)
        want = j_int4_ref(x, qd["q"], qd["scale"])
        got = int4_matmul_grouped(torch.from_numpy(x),
                                  torch.from_numpy(td["q"]),
                                  torch.from_numpy(td["scale"])).numpy()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale < 1e-5

    @pytest.mark.parametrize("m,k,n", SHAPES)
    def test_matches_pallas_interpret(self, m, k, n):
        """Against the Pallas kernel in interpret mode (exact f32
        weights there): 1e-5 of max|y|."""
        x, q, s = _inputs(8, m, k, n)
        want = np.asarray(j_int4_matmul(
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), interpret=True,
            out_dtype=jnp.float32), np.float32)
        got = int4_matmul_grouped(torch.from_numpy(x), torch.from_numpy(q),
                                  torch.from_numpy(s)).numpy()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale < 1e-5


# (M, N) of the main paths: decode steps (7B batch 8, Mistral batch 4,
# batch 1, BERT's pooler and classifier) and prefill (7B buckets up to
# 512, Mistral 4 x 512 and 1 x 4200, BERT batch 8 x 128)
DECODE_SHAPES = [(8, 12288), (8, 4096), (8, 22016), (8, 32000), (4, 6144),
                 (4, 28672), (1, 4096), (8, 768), (8, 2)]
PREFILL_SHAPES = [(512, 12288), (512, 22016), (512, 32000), (2048, 6144),
                  (2048, 28672), (4200, 4096), (1024, 768), (1024, 3072)]


class TestRoute:
    @pytest.mark.parametrize("m,n", DECODE_SHAPES)
    def test_decode_takes_cuda_cores(self, m, n):
        """Decode shapes take the split-K GEMV (``csrc/lowbit_gemv.cu``),
        which replaced the CUDA-core kernel."""
        assert matmul_route(m, n) == "gemv"

    @pytest.mark.parametrize("m,n", PREFILL_SHAPES)
    def test_prefill_takes_tensor_cores(self, m, n):
        assert matmul_route(m, n) == "tc"

    @pytest.mark.parametrize("m", [TC_MIN_M, 512, 4096])
    @pytest.mark.parametrize("n", [2, 3, 770, 4104])
    def test_n_not_multiple_of_16_takes_cuda_cores(self, m, n):
        """BERT's N = 2 classifier, N = 3 and 770: any M, on the GEMV."""
        assert matmul_route(m, n) == "gemv"

    def test_threshold(self):
        """The rule is a pure function of the shape around one constant."""
        assert 8 < TC_MIN_M <= 512
        assert matmul_route(TC_MIN_M - 1, 4096) == "gemv"
        assert matmul_route(TC_MIN_M, 4096) == "tc"


# (M, N) -> the tensor-core kernel's block tile, as timed on the H100:
# served buckets of the 7B linears, Mistral's prefill, BERT's M = 1024
TILE_SHAPES = [((16, 12288), (64, 64)), ((64, 4096), (64, 64)),
               ((16, 22016), (64, 128)), ((16, 32000), (64, 128)),
               ((128, 4096), (64, 64)), ((256, 4096), (64, 64)),
               ((128, 12288), (128, 128)), ((512, 4096), (128, 128)),
               ((512, 22016), (128, 128)), ((2048, 28672), (128, 128)),
               ((4200, 6144), (128, 128)), ((1024, 768), (64, 64)),
               ((1024, 3072), (128, 128))]


class TestBlockShape:
    @pytest.mark.parametrize("mn,tile", TILE_SHAPES)
    def test_main_path_tiles(self, mn, tile):
        assert tc_block_shape(*mn) == tile

    @pytest.mark.parametrize("m", [16, 63, 64, 65, 1000, 4096])
    @pytest.mark.parametrize("n", [16, 768, 8448, 8464, 28672])
    def test_rule(self, m, n):
        """64 x 64 exactly while its blocks make one wave at two a SM;
        otherwise 128-row blocks unless M <= 64."""
        tile = tc_block_shape(m, n)
        small = -(-m // 64) * -(-n // 64) <= 2 * TC_SMS
        assert (tile == (64, 64)) == small
        if not small:
            assert tile == ((128, 128) if m > 64 else (64, 128))

