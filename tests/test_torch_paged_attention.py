"""Kernel 2 of the port, ``paged_attention_decode_stats`` (flash state of
one decode query over a paged KV pool), with its merge and the decode
scatter, held against the JAX package on the same seeded numpy inputs:
the plain PyTorch version against the Pallas kernel in interpret mode
and against ``paged_attention_reference_stats``. Ragged lengths
(including 0), GQA and a sliding window are covered. The CUDA kernel
runs only on the card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.llm.kernels.paged_attention import (
    merge_attention_partial as j_merge)
from bigdl_tpu.llm.kernels.paged_attention import (
    paged_attention_decode_stats as j_stats)
from bigdl_tpu.llm.kernels.paged_attention import (
    paged_attention_reference_stats as j_ref_stats)
from bigdl_tpu.llm.serving import scatter_new_kv as j_scatter

from bigdl_tpu_torch.llm.kernels.paged_attention import (
    merge_attention_partial, paged_attention_decode_stats,
    paged_attention_reference_stats, paged_attention_stats)
from bigdl_tpu_torch.llm.serving import scatter_new_kv

PAGE = 16


def _setup(seed, B, Hq, Hkv, D, P=48, maxp=8, lens=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Hq, D).astype(np.float32)
    kp = rs.randn(P, Hkv, PAGE, D).astype(np.float32)
    vp = rs.randn(P, Hkv, PAGE, D).astype(np.float32)
    bt = rs.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    if lens is None:
        lens = rs.randint(0, maxp * PAGE + 1, B)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [  # (Hq, Hkv, D, lens, window)
    (4, 4, 16, [0, 5, 77, 128], None),
    (8, 4, 32, [1, 16, 17, 100], None),       # GQA g=2
    (4, 2, 16, [0, 3, 50, 128], 20),          # window, length 0
]


def _assert_state(got, want, tol):
    """acc (unnormalised), m and l all within ``tol`` of the reference
    (f32 math on identical inputs; only the summation order differs)."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol)


class TestPlainVersion:
    @pytest.mark.parametrize("hq,hkv,d,lens,win", CASES)
    def test_matches_pallas_interpret(self, hq, hkv, d, lens, win):
        """Tolerance 1e-4: f32 scores and exps of the same inputs."""
        q, kp, vp, bt, ln = _setup(0, 4, hq, hkv, d, lens=lens)
        want = j_stats(*_j(q, kp, vp, bt, ln), page_size=PAGE,
                       interpret=True, sliding_window=win)
        got = paged_attention_decode_stats(*_t(q, kp, vp, bt, ln),
                                           page_size=PAGE,
                                           sliding_window=win)
        _assert_state(got, want, 1e-4)

    @pytest.mark.parametrize("hq,hkv,d,lens,win", CASES)
    def test_matches_xla_reference(self, hq, hkv, d, lens, win):
        """Same gather-and-mask structure: 1e-5."""
        q, kp, vp, bt, ln = _setup(1, 4, hq, hkv, d, lens=lens)
        want = j_ref_stats(*_j(q, kp, vp, bt, ln), sliding_window=win)
        got = paged_attention_reference_stats(*_t(q, kp, vp, bt, ln),
                                              sliding_window=win)
        _assert_state(got, want, 1e-5)

    def test_empty_row_identity(self):
        q, kp, vp, bt, ln = _setup(2, 2, 4, 2, 16, lens=[0, 9])
        acc, m, l = paged_attention_stats(*_t(q, kp, vp, bt, ln),
                                          page_size=PAGE)
        assert float(acc[0].abs().max()) == 0.0
        assert torch.all(m[0] == -1e30) and torch.all(l[0] == 0)

    @pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
    def test_merge_matches_jax(self, hq, hkv):
        """The flash combine of the current token: 1e-5."""
        q, kp, vp, bt, ln = _setup(3, 4, hq, hkv, 16, lens=[0, 4, 60, 128])
        rs = np.random.RandomState(4)
        kn = rs.randn(4, hkv, 16).astype(np.float32)
        vn = rs.randn(4, hkv, 16).astype(np.float32)
        jst = j_ref_stats(*_j(q, kp, vp, bt, ln))
        want = j_merge(*jst, *_j(q, kn, vn))
        tst = paged_attention_reference_stats(*_t(q, kp, vp, bt, ln))
        got = merge_attention_partial(*tst, *_t(q, kn, vn))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_scatter_new_kv_matches_jax(self):
        """Advanced-index scatter semantics (the broadcast (B,) dim goes
        first, as in numpy/JAX): bit-identical pools."""
        rs = np.random.RandomState(5)
        L, P, H, D, B = 2, 10, 2, 8, 3
        kp = rs.randn(L, P, H, PAGE, D).astype(np.float32)
        vp = rs.randn(L, P, H, PAGE, D).astype(np.float32)
        bt = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
        lens = np.array([17, 33, 0], np.int32)
        kn = rs.randn(L, B, H, D).astype(np.float32)
        vn = rs.randn(L, B, H, D).astype(np.float32)
        wk, wv = j_scatter(*_j(kp, vp, bt, lens, kn, vn), page=PAGE)
        gk, gv = scatter_new_kv(*_t(kp.copy(), vp.copy(), bt, lens, kn, vn),
                                page=PAGE)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))

    def test_cpu_dispatch_launches_no_kernel(self):
        q, kp, vp, bt, ln = _setup(6, 2, 4, 4, 16)
        before = paged_attention_decode_stats.launches
        paged_attention_stats(*_t(q, kp, vp, bt, ln), page_size=PAGE)
        assert paged_attention_decode_stats.launches == before

    def test_shape_checks(self):
        q, kp, vp, bt, ln = _setup(7, 2, 4, 4, 16)
        with pytest.raises(ValueError, match="page_size"):
            paged_attention_stats(*_t(q, kp, vp, bt, ln), page_size=8)

