"""Kernels 2 and 6 of the port — ``paged_attention_decode_stats`` (flash
state of one decode query over a paged KV pool, with its merge and the
decode scatter) and ``paged_attention_decode`` (the normalised variant
behind the ``paged_attention()`` dispatch) — held against the JAX
package on the same seeded numpy inputs: the plain PyTorch versions
against the Pallas kernels in interpret mode and against the JAX
references. Ragged lengths, GQA and a sliding window are covered; length
0, where the two JAX functions differ, is asserted on each side. The
CUDA kernel's split-and-combine is modelled in plain PyTorch
(``split_stats_reference``) and held to the JAX reference too. The CUDA
kernel runs only on the card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.llm.kernels.paged_attention import (
    merge_attention_partial as j_merge)
from bigdl_tpu.llm.kernels.paged_attention import (
    paged_attention_decode as j_decode)
from bigdl_tpu.llm.kernels.paged_attention import (
    paged_attention_reference as j_ref)
from bigdl_tpu.llm.kernels.paged_attention import (
    paged_attention_decode_stats as j_stats)
from bigdl_tpu.llm.kernels.paged_attention import (
    paged_attention_reference_stats as j_ref_stats)
from bigdl_tpu.llm.serving import scatter_new_kv as j_scatter

from bigdl_tpu_torch.llm.kernels import launch_counts
from bigdl_tpu_torch.llm.kernels.paged_attention import (
    SPLIT_KEYS, merge_attention_partial, paged_attention,
    paged_attention_decode, paged_attention_decode_stats,
    paged_attention_reference, paged_attention_reference_stats,
    paged_attention_stats, split_stats_reference)
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
    (16, 1, 16, [0, 9, 64, 128], None),       # g=16 (GLM-4-9B's group)
    (48, 1, 8, [2, 31, 100, 128], 40),        # MQA g=48 (StarCoder's)
    (4, 2, 80, [1, 17, 90, 128], None),       # D=80
    (8, 2, 96, [0, 33, 66, 127], 50),         # D=96 (GPT-NeoX-20B's)
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



NORM_CASES = [  # (Hq, Hkv, D, lens >= 1, window)
    (4, 4, 16, [1, 5, 77, 128], None),        # MHA
    (8, 2, 32, [1, 16, 17, 100], None),       # GQA g=4
    (4, 2, 16, [2, 3, 50, 128], 20),          # GQA + window
    (16, 1, 16, [1, 9, 64, 128], None),       # g=16
    (48, 1, 8, [2, 31, 100, 128], 40),        # MQA g=48
    (4, 2, 80, [1, 17, 90, 128], None),       # D=80
    (8, 2, 96, [3, 33, 66, 127], 50),         # D=96
]


class TestNormalisedPlainVersion:
    """Kernel 6's plain version, ``paged_attention_reference``."""

    @pytest.mark.parametrize("hq,hkv,d,lens,win", NORM_CASES)
    def test_matches_pallas_interpret(self, hq, hkv, d, lens, win):
        """Tolerance 2e-5: f32 softmax of the same inputs, another order
        of summation (online in the kernel, one pass here)."""
        q, kp, vp, bt, ln = _setup(10, 4, hq, hkv, d, lens=lens)
        want = j_decode(*_j(q, kp, vp, bt, ln), page_size=PAGE,
                        interpret=True, sliding_window=win)
        got = paged_attention_decode(*_t(q, kp, vp, bt, ln),
                                     page_size=PAGE, sliding_window=win)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("hq,hkv,d,lens,win", NORM_CASES)
    def test_matches_xla_reference(self, hq, hkv, d, lens, win):
        """The same gather-and-softmax: 1e-5."""
        q, kp, vp, bt, ln = _setup(11, 4, hq, hkv, d, lens=lens)
        want = j_ref(*_j(q, kp, vp, bt, ln), sliding_window=win)
        got = paged_attention_reference(*_t(q, kp, vp, bt, ln),
                                        sliding_window=win)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_bf16_query_gives_bf16(self):
        """Output in q.dtype; the bf16 rounding of the f32 result is the
        only difference from the f32 query's output."""
        q, kp, vp, bt, ln = _setup(12, 4, 8, 2, 32, lens=[1, 9, 40, 128])
        qb = torch.from_numpy(q).to(torch.bfloat16)
        got = paged_attention(qb, *_t(kp, vp, bt, ln), page_size=PAGE)
        want = paged_attention_reference(qb.float(), *_t(kp, vp, bt, ln))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   rtol=2.0 ** -8, atol=1e-6)

    def test_length_zero_each_side(self):
        """Length 0 is where the two JAX functions part: the Pallas
        kernel returns 0 (acc = 0, l = 0), the reference a softmax over
        nothing but masked scores, which is uniform — the mean of the
        gathered V rows. The port's plain version follows the reference
        (the CUDA kernel follows the Pallas kernel: test_torch_cuda.py)."""
        q, kp, vp, bt, ln = _setup(13, 3, 4, 2, 16, lens=[0, 20, 5])
        kern = np.asarray(j_decode(*_j(q, kp, vp, bt, ln), page_size=PAGE,
                                   interpret=True))
        assert np.all(kern[0] == 0.0)
        want = np.asarray(j_ref(*_j(q, kp, vp, bt, ln)))
        got = paged_attention_reference(*_t(q, kp, vp, bt, ln)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # the live span is ceil(20 / 16) = 2 pages of row 0's table
        mean_v = vp[bt[0, :2]].transpose(1, 0, 2, 3).reshape(
            2, 2 * PAGE, 16).mean(axis=1)                  # (Hkv, D)
        np.testing.assert_allclose(got[0], np.repeat(mean_v, 2, axis=0),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("window", [None, 24])
    def test_write_then_attend_equals_stats_merge(self, window):
        """The identity the engine's decode rests on: stats over the
        first ``lens`` tokens (window shrunk by one) merged with the
        current token equal writing that token to its page and attending
        ``lens + 1`` tokens (1e-5, f32)."""
        rs = np.random.RandomState(14)
        B, Hq, Hkv, D = 3, 8, 2, 32
        q, kp, vp, bt, ln = _setup(15, B, Hq, Hkv, D, lens=[0, 37, 127])
        kn = rs.randn(B, Hkv, D).astype(np.float32)
        vn = rs.randn(B, Hkv, D).astype(np.float32)
        st = paged_attention_stats(*_t(q, kp, vp, bt, ln), page_size=PAGE,
                                   sliding_window=None if window is None
                                   else window - 1)
        got = merge_attention_partial(*st, *_t(q, kn, vn))
        kp2, vp2 = kp.copy(), vp.copy()
        for b in range(B):
            pid = bt[b, ln[b] // PAGE]
            kp2[pid, :, ln[b] % PAGE] = kn[b]
            vp2[pid, :, ln[b] % PAGE] = vn[b]
        want = paged_attention(*_t(q, kp2, vp2, bt, ln + 1), page_size=PAGE,
                               sliding_window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)

    def test_cpu_dispatch_launches_no_kernel(self):
        q, kp, vp, bt, ln = _setup(16, 2, 4, 4, 16, lens=[3, 40])
        before = launch_counts()
        paged_attention(*_t(q, kp, vp, bt, ln), page_size=PAGE)
        assert launch_counts() == before
        assert "paged_attention_decode" in before

    def test_checks(self):
        q, kp, vp, bt, ln = _setup(17, 2, 6, 4, 16, lens=[3, 40])
        with pytest.raises(ValueError, match="multiple"):
            paged_attention(*_t(q, kp, vp, bt, ln), page_size=PAGE)
        q, kp, vp, bt, ln = _setup(17, 2, 4, 4, 16, lens=[3, 40])
        with pytest.raises(ValueError, match="page_size"):
            paged_attention(*_t(q, kp, vp, bt, ln), page_size=8)
        with pytest.raises(ValueError, match="device"):
            paged_attention(*(t.to("meta") for t in _t(q, kp, vp, bt, ln)),
                            page_size=PAGE)


SPLIT_CASES = [  # (Hq, Hkv, D, lens, window, split_keys)
    (4, 4, 16, [0, 31, 32, 33, 127], None, 32),     # on and next to a cut
    (8, 2, 32, [1, 48, 49, 95, 128], None, 48),     # GQA g=4, 3-page splits
    (4, 2, 16, [0, 40, 63, 64, 100], 20, 32),       # window inside a split
    (4, 2, 16, [17, 64, 65, 96, 127], 32, 32),      # window = one split
    (8, 4, 16, [5, 70, 128, 33, 0], 50, 16),        # one page a split
    (4, 4, 16, [0, 9, 128, 100, 127], None, SPLIT_KEYS),
    (16, 1, 16, [0, 31, 33, 64, 128], None, 32),    # g=16: two head chunks
    (48, 1, 8, [5, 47, 48, 97, 128], 60, 48),       # MQA g=48: six chunks
    (24, 2, 96, [1, 63, 64, 65, 128], None, 64),    # g=12: chunks of 8 and 4
]


class TestSplitCombine:
    """The CUDA kernel's split-sequence algebra: a kv head's query heads
    taken 8 at a time (``HEAD_CHUNK``), each row's live range cut at the
    multiples of ``split_keys``, one flash state per split, combined in
    split order — against the JAX package's
    ``paged_attention_reference_stats`` on the same numpy inputs, with
    empty splits (a window that starts past them), length-0 rows and
    windows. f32 on both sides: 1e-5."""

    @pytest.mark.parametrize("hq,hkv,d,lens,win,split", SPLIT_CASES)
    def test_matches_xla_reference(self, hq, hkv, d, lens, win, split):
        q, kp, vp, bt, ln = _setup(20, len(lens), hq, hkv, d, lens=lens)
        want = j_ref_stats(*_j(q, kp, vp, bt, ln), sliding_window=win)
        got = split_stats_reference(*_t(q, kp, vp, bt, ln),
                                    sliding_window=win, split_keys=split)
        _assert_state(got, want, 1e-5)

    @pytest.mark.parametrize("split", [16, 32, 64])
    def test_normalised_matches_pallas_interpret(self, split):
        """``acc / l`` of the combined state equals the normalised Pallas
        kernel (interpret mode) on rows with lengths >= 1: 2e-5."""
        lens, win = [1, 33, 64, 100], 40
        q, kp, vp, bt, ln = _setup(21, 4, 8, 2, 16, lens=lens)
        want = j_decode(*_j(q, kp, vp, bt, ln), page_size=PAGE,
                        interpret=True, sliding_window=win)
        acc, _, l = split_stats_reference(*_t(q, kp, vp, bt, ln),
                                          sliding_window=win,
                                          split_keys=split)
        np.testing.assert_allclose((acc / l[..., None]).numpy(),
                                   np.asarray(want), rtol=2e-5, atol=2e-5)

    def test_split_keys_checked(self):
        """The wrapper refuses a split that is not a whole number of pages
        or is above the kernel's 512 (checked before any launch)."""
        from bigdl_tpu_torch.llm.kernels.paged_attention import _scratch
        q, kp, vp, bt, ln = _setup(22, 2, 4, 4, 16, lens=[3, 40])
        for bad in (24, 0, 1024):
            with pytest.raises(ValueError, match="split_keys"):
                _scratch(*_t(q, kp, bt), bad)
        nsplit, part_acc, part_ml, arrivals = _scratch(*_t(q, kp, bt), 32)
        assert nsplit == -(-bt.shape[1] * PAGE // 32)
        assert tuple(part_acc.shape) == (2 * 4, nsplit, 1, 16)
        assert tuple(part_ml.shape) == (2 * 4, nsplit, 2, 1)
        assert arrivals.dtype == torch.int32 and not arrivals.any()
        # g = 20: chunks of 8, 8 and 4 heads, one block each, the scratch
        # strided by the largest chunk
        q, kp, vp, bt, ln = _setup(22, 2, 40, 2, 16, lens=[3, 40])
        nsplit, part_acc, part_ml, arrivals = _scratch(*_t(q, kp, bt), 32)
        assert tuple(part_acc.shape) == (2 * 2 * 3, nsplit, 8, 16)
        assert tuple(part_ml.shape) == (2 * 2 * 3, nsplit, 2, 8)
        assert tuple(arrivals.shape) == (2 * 2 * 3,)
