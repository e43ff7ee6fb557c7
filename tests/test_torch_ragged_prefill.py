"""Kernel 3 of the port, ``ragged_prefill_attention`` (suffix queries over
in-place KV pages plus their own dense K/V), with the prefill scatter
and COW fork, held against the JAX package on the same seeded numpy
inputs: the plain PyTorch version against the Pallas kernel in
interpret mode and against ``ragged_prefill_reference``. Offset 0 and
offset > 0, GQA and a window are covered, and padded query rows must be
finite. ``ragged_tiles_reference``, the plain model of the tensor-core
kernel's tile walk and bf16 P, is held to both as well. The CUDA kernels
run only on the card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.llm.kernels.ragged_prefill import (
    ragged_prefill_attention as j_ragged)
from bigdl_tpu.llm.kernels.ragged_prefill import (
    ragged_prefill_reference as j_ragged_ref)
from bigdl_tpu.llm.kvcache.prefill import fork_tail_pages as j_fork
from bigdl_tpu.llm.kvcache.prefill import scatter_suffix_kv as j_scatter

from bigdl_tpu_torch.llm.kernels.ragged_prefill import (
    ragged_prefill, ragged_prefill_attention, ragged_prefill_reference,
    ragged_route, ragged_tiles_reference)
from bigdl_tpu_torch.llm.kvcache.prefill import (fork_tail_pages,
                                                 scatter_suffix_kv)

PAGE = 16


def _setup(seed, B, Tq, Hq, Hkv, D, offsets, seq_lens, P=40, maxp=8):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Tq, Hq, D).astype(np.float32)
    ks = rs.randn(B, Tq, Hkv, D).astype(np.float32)
    vs = rs.randn(B, Tq, Hkv, D).astype(np.float32)
    kp = rs.randn(P, Hkv, PAGE, D).astype(np.float32)
    vp = rs.randn(P, Hkv, PAGE, D).astype(np.float32)
    bt = rs.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    return (q, ks, vs, kp, vp, bt, np.asarray(offsets, np.int32),
            np.asarray(seq_lens, np.int32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [  # (Tq, Hq, Hkv, D, offsets, seq_lens, window)
    (16, 4, 4, 16, [0, 0], [16, 9], None),            # offset 0
    (16, 4, 2, 16, [37, 5], [12, 16], None),          # offset > 0, GQA
    (24, 8, 2, 32, [64, 0], [20, 3], 30),             # window, ragged
]


def _valid_rows(out, seq_lens):
    return [np.asarray(out)[b, :n] for b, n in enumerate(seq_lens)]


class TestPlainVersion:
    @pytest.mark.parametrize("tq,hq,hkv,d,offs,lens,win", CASES)
    def test_matches_pallas_interpret(self, tq, hq, hkv, d, offs, lens,
                                      win):
        """Valid rows within 1e-4 (f32 softmax of identical inputs); the
        padded rows are finite on both sides."""
        args = _setup(0, 2, tq, hq, hkv, d, offs, lens)
        want = j_ragged(*_j(*args), page_size=PAGE, interpret=True,
                        sliding_window=win)
        got = ragged_prefill_attention(*_t(*args), page_size=PAGE,
                                       sliding_window=win)
        assert got.shape == (2, tq, hq, d) and got.dtype == torch.float32
        assert torch.isfinite(got).all()
        for g, w in zip(_valid_rows(got, lens), _valid_rows(want, lens)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("tq,hq,hkv,d,offs,lens,win", CASES)
    def test_matches_xla_reference(self, tq, hq, hkv, d, offs, lens, win):
        """Same structure as the XLA twin, every row: 1e-5."""
        args = _setup(1, 2, tq, hq, hkv, d, offs, lens)
        want = j_ragged_ref(*_j(*args), sliding_window=win)
        got = ragged_prefill_reference(*_t(*args), sliding_window=win)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_padded_rows_finite_when_nothing_valid(self):
        """A row with no valid key at all (offset 0, seq_len 0) stays
        finite."""
        args = _setup(2, 1, 8, 2, 2, 16, [0], [0])
        got = ragged_prefill(*_t(*args), page_size=PAGE)
        assert torch.isfinite(got).all()

    def test_cpu_dispatch_launches_no_kernel(self):
        args = _setup(3, 1, 8, 2, 2, 16, [3], [5])
        before = ragged_prefill_attention.launches
        ragged_prefill(*_t(*args), page_size=PAGE)
        assert ragged_prefill_attention.launches == before


# the tensor-core kernel's walk: g = 1, 4 and 16 (query tiles of 64 rows
# = 4 tokens), D = 16, 32 and 80, offsets off the page and the tile,
# seq_len not a multiple of 64, a window that cuts a key tile
TILE_CASES = [  # (Tq, Hq, Hkv, D, offsets, seq_lens, window)
    (12, 16, 1, 16, [37, 5], [12, 7], None),
    (40, 8, 2, 32, [70, 0], [40, 33], 50),
    (72, 2, 2, 80, [19, 100], [72, 65], None),
]


def _tiles_tol(args, p_dtype):
    """bf16 P: 2^-8 of max|V| (P's rounding, relative 2^-9, on a convex
    combination of V rows); f32 P: 1e-5 (the online softmax's order)."""
    vmax = max(np.abs(args[2]).max(), np.abs(args[4]).max())
    return 2.0 ** -8 * vmax if p_dtype == torch.bfloat16 else 1e-5


class TestTilesModel:
    @pytest.mark.parametrize("p_dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("tq,hq,hkv,d,offs,lens,win", TILE_CASES)
    def test_matches_xla_reference(self, tq, hq, hkv, d, offs, lens, win,
                                   p_dtype):
        args = _setup(6, 2, tq, hq, hkv, d, offs, lens)
        want = np.asarray(j_ragged_ref(*_j(*args), sliding_window=win))
        got = ragged_tiles_reference(*_t(*args), sliding_window=win,
                                     p_dtype=p_dtype)
        assert got.shape == (2, tq, hq, d) and torch.isfinite(got).all()
        tol = _tiles_tol(args, p_dtype)
        for g, w in zip(_valid_rows(got, lens), _valid_rows(want, lens)):
            assert np.abs(g - w).max() <= tol
        # rows past seq_len are 0, as the kernel writes them
        for b, n in enumerate(lens):
            assert not got[b, n:].any()

    @pytest.mark.parametrize("tq,hq,hkv,d,offs,lens,win", TILE_CASES)
    def test_matches_pallas_interpret(self, tq, hq, hkv, d, offs, lens,
                                      win):
        args = _setup(7, 2, tq, hq, hkv, d, offs, lens)
        want = j_ragged(*_j(*args), page_size=PAGE, interpret=True,
                        sliding_window=win)
        got = ragged_tiles_reference(*_t(*args), sliding_window=win)
        tol = _tiles_tol(args, torch.bfloat16)
        for g, w in zip(_valid_rows(got, lens), _valid_rows(want, lens)):
            assert np.abs(g - w).max() <= tol

    @pytest.mark.parametrize("qt,kt,d,page,route", [
        (torch.bfloat16, torch.bfloat16, 128, 16, "tc"),
        (torch.bfloat16, torch.bfloat16, 80, 8, "tc"),
        (torch.float32, torch.bfloat16, 128, 16, "cuda_core"),
        (torch.bfloat16, torch.float32, 128, 16, "cuda_core"),
        (torch.bfloat16, torch.bfloat16, 72, 16, "cuda_core"),
        (torch.bfloat16, torch.bfloat16, 128, 12, "cuda_core")])
    def test_route(self, qt, kt, d, page, route):
        """bf16 q and pools, D % 16 == 0, D <= 128, page % 8 == 0 take
        the tensor cores; the rest the f32 CUDA-core kernel."""
        q = torch.zeros((1, 4, 2, d), dtype=qt)
        kp = torch.zeros((3, 2, page, d), dtype=kt)
        assert ragged_route(q, kp) == route


class TestPrefillScatter:
    def test_scatter_suffix_kv_matches_jax(self):
        """One scatter of every layer's suffix K/V, padding to trash
        page 0: bit-identical pools."""
        rs = np.random.RandomState(4)
        L, P, H, D, T = 2, 6, 2, 8, 8
        kp = rs.randn(L, P, H, PAGE, D).astype(np.float32)
        vp = rs.randn(L, P, H, PAGE, D).astype(np.float32)
        phys = np.array([3, 3, 3, 3, 3, 0, 0, 0], np.int32)
        slots = np.array([11, 12, 13, 14, 15, 0, 1, 2], np.int32)
        kn = rs.randn(L, T, H, D).astype(np.float32)
        vn = rs.randn(L, T, H, D).astype(np.float32)
        wk, wv = j_scatter(*_j(kp, vp, phys, slots, kn, vn))
        gk, gv = scatter_suffix_kv(*_t(kp.copy(), vp.copy(), phys, slots,
                                       kn, vn))
        # page 0 takes duplicate writes (trash): compare the real pages
        np.testing.assert_array_equal(gk.numpy()[:, 1:],
                                      np.asarray(wk)[:, 1:])
        np.testing.assert_array_equal(gv.numpy()[:, 1:],
                                      np.asarray(wv)[:, 1:])

    def test_fork_tail_pages_matches_jax(self):
        rs = np.random.RandomState(5)
        kp = rs.randn(2, 5, 2, PAGE, 8).astype(np.float32)
        vp = rs.randn(2, 5, 2, PAGE, 8).astype(np.float32)
        for dst, src in ((4, 2), (0, 0)):
            wk, wv = j_fork(*_j(kp, vp), dst, src)
            gk, gv = fork_tail_pages(*_t(kp.copy(), vp.copy()), dst, src)
            np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))

