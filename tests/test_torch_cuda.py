"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports neither JAX nor ``bigdl_tpu``, so it runs on a machine that
has only PyTorch (the tests' conftest imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is built from ``bigdl_tpu_torch/csrc`` at its first launch.
The CPU parity of the plain versions against the JAX package lives in
``tests/test_torch_{int4_matmul,low_bit,paged_attention,ragged_prefill}.py``.
"""

import pytest
import torch

from bigdl_tpu_torch.llm.kernels.int4_matmul import (
    asym_int4_matmul, asym_int4_matmul_reference, int4_matmul,
    int4_matmul_reference, int8_matmul, int8_matmul_reference)
from bigdl_tpu_torch.llm.kernels.paged_attention import (
    paged_attention_decode_stats, paged_attention_reference_stats)
from bigdl_tpu_torch.llm.kernels.ragged_prefill import (
    ragged_prefill_attention, ragged_prefill_reference)

PAGE = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 12288),
                                   (8, 11008, 4096), (37, 256, 132),
                                   (8, 768, 2), (37, 256, 3),
                                   (1024, 768, 770)])
def test_int4_matmul(cuda, m, k, n):
    """Same bf16 x and f32 weights on both sides; f32 sums in another
    order: 1e-4 of max|y| for f32 out, plus one bf16 ulp of max|y|
    (2^-7 of it) for the bf16 out the served path uses. Exactly one
    launch per call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randint(0, 256, (k // 2, n), generator=g, device=cuda,
                      dtype=torch.uint8)
    s = torch.rand((k // 32, n), generator=g, device=cuda) * 0.02
    before = int4_matmul.launches
    got = int4_matmul(x, q, s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert int4_matmul.launches == before + 1
    want = int4_matmul_reference(x, q, s, torch.float32)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() / scale < 1e-4
    got16 = int4_matmul(x, q, s)
    assert got16.dtype == torch.bfloat16
    want16 = int4_matmul_reference(x, q, s, torch.bfloat16)
    err16 = (got16.float() - want16.float()).abs().max().item()
    assert err16 / scale < 2.0 ** -7 + 1e-4


def test_int4_matmul_rows_independent(cuda):
    """The summation order of an output element does not depend on M:
    row 3 of an M=37 product equals the same row computed alone."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((37, 1024), generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randint(0, 256, (512, 256), generator=g, device=cuda,
                      dtype=torch.uint8)
    s = torch.rand((32, 256), generator=g, device=cuda) * 0.02
    full = int4_matmul(x, q, s, out_dtype=torch.float32)
    alone = int4_matmul(x[3:4].contiguous(), q, s, out_dtype=torch.float32)
    assert torch.equal(full[3:4], alone)


def _lowbit_inputs(kind, m, k, n, seed, device):
    """bf16 x and random planes in the k-major layout: q4_1 nibbles with
    scale and zero, or q8_0 int8 with scale."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    s = torch.empty((k // 32, n), device=device).uniform_(
        0.001, 0.02, generator=g)
    if kind == "asym_int4":
        q = torch.randint(0, 256, (k // 2, n), generator=g, device=device,
                          dtype=torch.uint8)
        z = torch.empty((k // 32, n), device=device).uniform_(
            -0.15, 0.0, generator=g)
        return x, (q, s, z)
    q = torch.randint(-127, 128, (k, n), generator=g, device=device,
                      dtype=torch.int8)
    return x, (q, s)


LOWBIT = {"asym_int4": (asym_int4_matmul, asym_int4_matmul_reference),
          "sym_int8": (int8_matmul, int8_matmul_reference)}


@pytest.mark.parametrize("kind", sorted(LOWBIT))
@pytest.mark.parametrize("m,k,n", [(8, 768, 2), (1024, 768, 768),
                                   (64, 768, 3072), (37, 3072, 768),
                                   (5, 96, 130)])
def test_lowbit_matmul(cuda, kind, m, k, n):
    """Same bf16 x and f32 dequantized weights on both sides, f32 sums in
    another order: 2e-5 of max|y| for f32 out; for bf16 out that plus
    one bf16 ulp of max|y| (2^-7 of it). Exactly one launch per call."""
    fn, ref = LOWBIT[kind]
    x, planes = _lowbit_inputs(kind, m, k, n, 0, cuda)
    before = fn.launches
    got = fn(x, *planes, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ref(x, *planes, torch.float32)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale
    got16 = fn(x, *planes)
    assert got16.dtype == torch.bfloat16
    err16 = (got16.float() - ref(x, *planes, torch.bfloat16).float()) \
        .abs().max().item()
    assert err16 <= 1e-4 + 2.0 ** -7 * scale


@pytest.mark.parametrize("kind", sorted(LOWBIT))
def test_lowbit_matmul_rows_independent(cuda, kind):
    """Row 3 of an M=130 product equals the same row computed alone."""
    fn, _ = LOWBIT[kind]
    x, planes = _lowbit_inputs(kind, 130, 512, 200, 1, cuda)
    full = fn(x, *planes, out_dtype=torch.float32)
    alone = fn(x[3:4].contiguous(), *planes, out_dtype=torch.float32)
    assert torch.equal(full[3:4], alone)


def test_int8_matmul_broadcast_scale(cuda):
    """A per-channel scale expanded over the groups (row stride 0, as
    ``nn.quantized.Linear`` passes it) equals the materialised one."""
    x, (q, s) = _lowbit_inputs("sym_int8", 40, 768, 300, 2, cuda)
    view = s[:1].expand(s.shape[0], s.shape[1])
    assert view.stride(0) == 0
    got = int8_matmul(x, q, view, out_dtype=torch.float32)
    want = int8_matmul(x, q, view.contiguous(), out_dtype=torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hq,hkv,d,win", [(32, 32, 128, None),
                                          (32, 8, 128, None),
                                          (32, 32, 64, None),
                                          (8, 2, 64, 40)])
def test_paged_attention_decode_stats(cuda, hq, hkv, d, win):
    """bf16 pools, f32 math on both sides: 1e-3 on the normalised output
    and on m, relative 1e-3 on l; empty rows are the combine identity."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, P, maxp = 8, 200, 24
    q = torch.randn((B, hq, d), generator=g, device=cuda)
    kp = torch.randn((P, hkv, PAGE, d), generator=g,
                     device=cuda).to(torch.bfloat16)
    vp = torch.randn((P, hkv, PAGE, d), generator=g,
                     device=cuda).to(torch.bfloat16)
    bt = torch.randperm(P, generator=g, device=cuda)[:B * maxp] \
        .reshape(B, maxp).to(torch.int32)
    ln = torch.tensor([0, 1, 15, 16, 17, 100, 255, 384], device=cuda,
                      dtype=torch.int32)
    acc, m, l = paged_attention_decode_stats(q, kp, vp, bt, ln,
                                             page_size=PAGE,
                                             sliding_window=win)
    torch.cuda.synchronize()
    racc, rm, rl = paged_attention_reference_stats(q, kp, vp, bt, ln,
                                                   sliding_window=win)
    live = ln > 0
    out = acc[live] / l[live][..., None]
    rout = racc[live] / rl[live][..., None]
    assert (out - rout).abs().max().item() < 1e-3
    assert (m - rm).abs().max().item() < 1e-3
    assert ((l - rl).abs() / rl.clamp(min=1)).max().item() < 1e-3
    assert torch.all(m[~live] == -1e30) and torch.all(l[~live] == 0)
    assert torch.all(acc[~live] == 0)


@pytest.mark.parametrize("hq,hkv,d,off,slen,tq,win", [
    (32, 32, 128, 0, 300, 512, None), (32, 8, 128, 37, 100, 128, None),
    (32, 32, 64, 80, 60, 64, None), (8, 2, 64, 50, 90, 128, 40)])
def test_ragged_prefill_attention(cuda, hq, hkv, d, off, slen, tq, win):
    """bf16 K/V, f32 math on both sides: valid rows within 1e-3, padded
    rows finite."""
    g = torch.Generator(device=cuda).manual_seed(0)
    P, maxp = 64, 32
    q = torch.randn((1, tq, hq, d), generator=g, device=cuda)
    ks, vs = (torch.randn((1, tq, hkv, d), generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    kp, vp = (torch.randn((P, hkv, PAGE, d), generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    bt = torch.randperm(P, generator=g, device=cuda)[:maxp] \
        .reshape(1, maxp).to(torch.int32)
    offs = torch.tensor([off], dtype=torch.int32, device=cuda)
    lens = torch.tensor([slen], dtype=torch.int32, device=cuda)
    got = ragged_prefill_attention(q, ks, vs, kp, vp, bt, offs, lens,
                                   page_size=PAGE, sliding_window=win)
    torch.cuda.synchronize()
    want = ragged_prefill_reference(q, ks, vs, kp, vp, bt, offs, lens,
                                    sliding_window=win)
    assert torch.isfinite(got).all()
    assert (got[:, :slen] - want[:, :slen]).abs().max().item() < 1e-3
