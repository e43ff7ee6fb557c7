"""Kernels 4 and 5 of the port, ``asym_int4_matmul`` (q4_1) and
``int8_matmul`` (q8_0), and the low-bit modules that run them
(``LowBitLinear``, ``nn.quantized.Linear``), held against the JAX package
on the same seeded numpy inputs:

- quantization and the k-major layout bit for bit;
- each kernel's plain PyTorch version against the Pallas kernel run in
  interpret mode (f32 out);
- the tensor-core kernels' group-scaled algebra
  (``asym_int4_matmul_grouped``, ``int8_matmul_grouped``) against the
  same, and the route and tile rules and C entries they launch through;
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
from bigdl_tpu.llm.kernels.int4_matmul import int4_matmul as j_int4_matmul
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
    GEMV_WARPS, TC_MIN_M, _slice_bounds, asym_int4_matmul,
    asym_int4_matmul_grouped, dequant_q4, dequant_q4_1, dequant_q8_0,
    gemv_slices, int4_matmul, int4_matmul_grouped, int8_matmul,
    int8_matmul_grouped, matmul_route, quantize_tpu, tc_block_shape,
    to_tpu_layout)
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


class TestGroupedAlgebra:
    """The tensor-core kernels' algebra in plain PyTorch — per 32-row
    group an exact f32 partial ``x_g @ q_g`` (and the row sums ``X_g``),
    then ``acc += s_g * P_g (+ z_g * X_g)`` in group order — against the
    Pallas kernels in interpret mode and against the JAX package's numpy
    dequant + f32 matmul. Tolerance 1e-5 of max|y|: the same bf16 x and
    exact f32 products on every side, summed in other orders."""

    @staticmethod
    def _close(got, want):
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(np.asarray(got) - want).max() / scale < 1e-5

    @pytest.mark.parametrize("m,k,n", KSHAPES)
    def test_asym_int4_matches_pallas_interpret(self, m, k, n):
        x, td = _kernel_inputs(11, "asym_int4", m, k, n)
        want = np.asarray(j_asym_int4_matmul(
            jnp.asarray(x), jnp.asarray(td["q"]), jnp.asarray(td["scale"]),
            jnp.asarray(td["zero"]), interpret=True,
            out_dtype=jnp.float32), np.float32)
        got = asym_int4_matmul_grouped(
            torch.from_numpy(x), *(torch.from_numpy(td[key])
                                   for key in ("q", "scale", "zero")),
            out_dtype=torch.float32)
        self._close(got.numpy(), want)

    @pytest.mark.parametrize("m,k,n", KSHAPES)
    def test_asym_int4_matches_jax_reference(self, m, k, n):
        rs = np.random.RandomState(12)
        x = _bf16_exact(rs.randn(m, k).astype(np.float32))
        qd = j_quantize((rs.randn(n, k) * 0.1 + 0.02).astype(np.float32),
                        "asym_int4")
        want = x @ j_dequantize(qd).T
        td = j_layout(qd)
        got = asym_int4_matmul_grouped(
            torch.from_numpy(x), *(torch.from_numpy(td[key])
                                   for key in ("q", "scale", "zero")))
        self._close(got.numpy(), want)

    @pytest.mark.parametrize("m,k,n", KSHAPES)
    def test_int8_matches_pallas_interpret(self, m, k, n):
        x, td = _kernel_inputs(13, "sym_int8", m, k, n)
        want = np.asarray(j_int8_matmul(
            jnp.asarray(x), jnp.asarray(td["q"]), jnp.asarray(td["scale"]),
            interpret=True, out_dtype=jnp.float32), np.float32)
        got = int8_matmul_grouped(torch.from_numpy(x),
                                  torch.from_numpy(td["q"]),
                                  torch.from_numpy(td["scale"]),
                                  out_dtype=torch.float32)
        self._close(got.numpy(), want)

    @pytest.mark.parametrize("m,k,n", KSHAPES)
    def test_int8_matches_jax_reference(self, m, k, n):
        rs = np.random.RandomState(14)
        x = _bf16_exact(rs.randn(m, k).astype(np.float32))
        qd = j_quantize((rs.randn(n, k) * 0.1).astype(np.float32),
                        "sym_int8")
        want = x @ j_dequantize(qd).T
        td = j_layout(qd)
        got = int8_matmul_grouped(torch.from_numpy(x),
                                  torch.from_numpy(td["q"]),
                                  torch.from_numpy(td["scale"]))
        self._close(got.numpy(), want)

    @pytest.mark.parametrize("m,k,n", KSHAPES)
    def test_int8_per_channel(self, m, k, n):
        """A per-channel scale as ``nn.quantized.Linear`` passes it (one
        row, stride 0 over the groups) against the Pallas kernel on the
        broadcast scale and against the JAX package's
        ``nn.quantized.Linear`` arithmetic, ``x @ (q * s)`` in f32."""
        rs = np.random.RandomState(15)
        x = _bf16_exact(rs.randn(m, k).astype(np.float32))
        q = rs.randint(-127, 128, (k, n)).astype(np.int8)
        s = rs.uniform(0.001, 0.02, n).astype(np.float32)
        s_t = np.broadcast_to(s, (k // QK, n))
        want = np.asarray(j_int8_matmul(
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(s_t),
            interpret=True, out_dtype=jnp.float32), np.float32)
        view = torch.from_numpy(s)[None, :].expand(k // QK, n)
        assert view.stride(0) == 0
        got = int8_matmul_grouped(torch.from_numpy(x), torch.from_numpy(q),
                                  view, out_dtype=torch.float32).numpy()
        self._close(got, want)
        self._close(got, x @ (q.astype(np.float32) * s))


GEMV_FORMATS = {"sym_int4": (j_int4_matmul, int4_matmul_grouped),
                "asym_int4": (j_asym_int4_matmul, asym_int4_matmul_grouped),
                "sym_int8": (j_int8_matmul, int8_matmul_grouped)}


class TestGemvOrder:
    """The GEMV's sum order (``csrc/lowbit_gemv.cu``) in plain PyTorch:
    ``gemv_slices(K, N)`` contiguous K slices, group order inside each,
    the slices added in order."""

    @pytest.mark.parametrize("qtype", sorted(GEMV_FORMATS))
    @pytest.mark.parametrize("m", [1, 3, 8])
    @pytest.mark.parametrize("k,n", [(64, 2), (128, 48), (256, 130)])
    def test_matches_pallas_interpret(self, qtype, m, k, n):
        """Against the Pallas kernel in interpret mode: 1e-5 of max|y|
        (exact f32 products of the same bf16 x, other orders)."""
        x, td = _kernel_inputs(16, qtype, m, k, n)
        planes = [td[key] for key in ("q", "scale", "zero") if key in td]
        jfn, fn = GEMV_FORMATS[qtype]
        want = np.asarray(jfn(jnp.asarray(x), *map(jnp.asarray, planes),
                              interpret=True, out_dtype=jnp.float32),
                          np.float32)
        got = fn(torch.from_numpy(x), *map(torch.from_numpy, planes),
                 out_dtype=torch.float32, slices=gemv_slices(k, n))
        TestGroupedAlgebra._close(got.numpy(), want)

    @pytest.mark.parametrize("k,n", [(64, 2), (768, 768), (4096, 4096),
                                     (4096, 12288), (11008, 4096),
                                     (14336, 4096), (4096, 32000)])
    def test_slices_rule(self, k, n):
        """A power of two from ``GEMV_WARPS`` to 8 blocks of them, from
        (K, N) alone; the slices cover the groups in order, once."""
        s = gemv_slices(k, n)
        assert s & (s - 1) == 0 and GEMV_WARPS <= s <= 8 * GEMV_WARPS
        bounds = _slice_bounds(k // QK, s)
        assert [b for b, _ in bounds[1:]] == [e for _, e in bounds[:-1]]
        assert (bounds[0][0], bounds[-1][1]) == (0, k // QK)


# (M, N) of the low-bit BERT path: the 72 M = 1024 linears a forward take
# the tensor cores, the pooler and N = 2 classifier (M = 8) and an N that
# is not a multiple of 16 the GEMV
BERT_ROUTES = [((1024, 768), "tc"), ((1024, 3072), "tc"),
               ((8, 768), "gemv"), ((8, 2), "gemv"),
               ((1024, 2), "gemv"), ((1024, 130), "gemv"),
               ((TC_MIN_M - 1, 768), "gemv"), ((TC_MIN_M, 768), "tc")]
# the tensor-core tile at those shapes for q8_0 (no zero point) and q4_1
# (zero point), as timed on the H100 (PERF.md)
BERT_TILES = [((1024, 768), (64, 64), (64, 64)),
              ((1024, 3072), (128, 128), (64, 64)),
              ((16, 768), (64, 64), (64, 64)),
              ((2047, 768), (128, 128), (64, 64)),
              ((64, 28672), (64, 128), (64, 128))]


class TestRoute:
    """One route rule (``matmul_route``) and one tile rule
    (``tc_block_shape``) for the three dequant-matmul formats."""

    @pytest.mark.parametrize("mn,route", BERT_ROUTES)
    def test_bert_shapes(self, mn, route):
        assert matmul_route(*mn) == route

    @pytest.mark.parametrize("mn,tile,tile_zero_point", BERT_TILES)
    def test_bert_tiles(self, mn, tile, tile_zero_point):
        assert tc_block_shape(*mn) == tile
        assert tc_block_shape(*mn, zero_point=True) == tile_zero_point

    @pytest.mark.parametrize("m", [16, 64, 65, 1000, 4096])
    @pytest.mark.parametrize("n", [16, 768, 8448, 28672])
    def test_zero_point_never_takes_128_rows(self, m, n):
        """q4_1 takes q4_0's tile except its 128 x 128, which becomes
        64 x 64 (timed faster on the H100)."""
        tile = tc_block_shape(m, n)
        want = (64, 64) if tile == (128, 128) else tile
        assert tc_block_shape(m, n, zero_point=True) == want

    @pytest.mark.parametrize("m", [1, 8, TC_MIN_M - 1, TC_MIN_M, 1024])
    @pytest.mark.parametrize("n", [2, 16, 130, 768, 3072])
    def test_rule(self, m, n):
        assert matmul_route(m, n) == (
            "tc" if m >= TC_MIN_M and n % 16 == 0 else "gemv")


def _c_params(lib, entry):
    """The parameter kinds of a C entry in ``csrc/<lib>.cu``: "P" for a
    pointer (or the stream), "I" for a ``long long``."""
    import os
    import re
    from bigdl_tpu_torch.llm.kernels import _build
    with open(os.path.join(_build.CSRC, f"{lib}.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, f"{entry} not in {lib}.cu"
    return ["I" if "long long" in p else "P" for p in m.group(1).split(",")]


class TestLaunchBinding:
    """``_launch`` binds the C entry of the route and format with the
    entry's own parameter list (read from the source: a pointer declared
    as an integer would be cut to 32 bits) and counts the launch. The
    library is not loaded: ``_build.bind`` is replaced by a recorder."""

    @pytest.mark.parametrize("kind", ["int4_matmul", "asym_int4_matmul",
                                      "int8_matmul"])
    @pytest.mark.parametrize("route", ["gemv", "tc"])
    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
    def test_entry_and_arguments(self, monkeypatch, kind, route, out_dtype):
        import importlib
        from bigdl_tpu_torch.llm.kernels import _build
        mod = importlib.import_module("bigdl_tpu_torch.llm.kernels."
                                      "int4_matmul")
        calls = []

        def bind(lib, entry, argtypes):
            def fn(*args):
                calls.append((lib, entry, argtypes, args))
                return 0
            return fn

        monkeypatch.setattr(_build, "bind", bind)
        monkeypatch.setattr(mod, "_stream", lambda x: 0)
        wrapper = {"int4_matmul": int4_matmul,
                   "asym_int4_matmul": asym_int4_matmul,
                   "int8_matmul": int8_matmul}[kind]
        m, k, n = 32, 64, 48
        x = torch.zeros((m, k), dtype=torch.bfloat16)
        q = torch.zeros((k if kind == "int8_matmul" else k // 2, n),
                        dtype=torch.int8 if kind == "int8_matmul"
                        else torch.uint8)
        planes = [q, torch.zeros((k // QK, n))]
        if kind == "asym_int4_matmul":
            planes.append(torch.zeros((k // QK, n)))
        out = torch.empty((m, n), dtype=out_dtype)
        lds = None if kind == "int4_matmul" else n
        before = (wrapper.launches, wrapper.tc_launches,
                  wrapper.gemv_launches)
        assert mod._launch(wrapper, x, planes, out, route, lds) == 0
        tc = route == "tc"
        assert (wrapper.launches, wrapper.tc_launches,
                wrapper.gemv_launches) == (before[0] + 1, before[1] + tc,
                                           before[2] + (not tc))
        (lib, entry, argtypes, args), = calls
        assert lib == mod._LIBS[kind][route]
        assert entry == (f"{kind}_{route}_"
                         f"{'bf16' if out_dtype == torch.bfloat16 else 'f32'}"
                         "out")
        kinds = ["I" if a is _build.I else "P" for a in argtypes]
        assert kinds == _c_params(lib, entry)
        assert len(args) == len(argtypes)
        # x, the planes and out by pointer, then M, K, N (lds), then the
        # tile or the GEMV's K slices
        ints = list(args[len(planes) + 2:-1])
        assert ints[:3] == [m, k, n]
        if lds is not None:
            assert ints[3] == lds
        if tc:
            assert tuple(ints[-2:]) == tc_block_shape(
                m, n, kind == "asym_int4_matmul")
        else:
            assert ints[-1] == gemv_slices(k, n)


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
        """nf4 and fp4, once refused, make the JAX module's states; a
        qtype the JAX package does not know raises its ValueError."""
        w = _weights(10, 8, 64)
        for qtype in ("nf4", "fp4"):
            _assert_same_tree(
                LowBitLinear.from_weight(w, qtype).states_dict(),
                jax.tree_util.tree_map(np.asarray, JLowBitLinear.from_weight(
                    w, qtype).states_dict()))
        for make in (JLowBitLinear.from_weight, LowBitLinear.from_weight):
            with pytest.raises(ValueError, match="unknown qtype"):
                make(w, "int3")


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
