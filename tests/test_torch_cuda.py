"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports neither JAX nor ``bigdl_tpu``, so it runs on a machine that
has only PyTorch (the tests' conftest imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is built from ``bigdl_tpu_torch/csrc`` at its first launch.
The last tests run the served decode step and ``generate``'s paged step
as captured CUDA graphs (``llm/graphs.py``): bit for bit against the
eager step, with exact launch counts, at pipeline depths 1 and 2; then
the mixed and speculative verify steps alike, and the served prefix
cache, mixed dispatch, speculation and preemption; then the same steps
of a mixture-of-experts model at both capacity modes, the slot-static
engine's step, and both engines served; the host KV tier's
transfers and the engine serving through it; last the engine's
instruments (the same host calls and kernels a pass with observability
on and off) and its watchdog through a warmed run. The DLlib training
tests hold ``resnet_cifar(8)``'s optimizer step on the card to the CPU
step, and check that the training entry points refuse ``device=None``
without a GPU (that one runs on any machine); the last three hold an
Inception-v1 step, a Keras ``fit`` and a PTB LSTM step on the card to
the CPU. The last holds each Chronos forecaster's forward and one
``fit`` step on the card to the CPU.
The CPU parity of the plain versions against the JAX package lives in
``tests/test_torch_{int4_matmul,low_bit,paged_attention,ragged_prefill}.py``,
and of ``generate`` in ``tests/test_torch_generate.py``.
"""

import time

import pytest
import torch

from bigdl_tpu_torch.llm.kernels.int4_matmul import (
    TC_MIN_M, asym_int4_matmul, asym_int4_matmul_reference, int4_matmul,
    int4_matmul_reference, matmul_route, int8_matmul, int8_matmul_reference)
from bigdl_tpu_torch.llm.kernels.paged_attention import (
    SPLIT_KEYS, merge_attention_partial, paged_attention,
    paged_attention_decode, paged_attention_decode_stats,
    paged_attention_reference, paged_attention_reference_stats)
from bigdl_tpu_torch.llm.kernels.ragged_prefill import (
    ragged_prefill_attention, ragged_prefill_reference, ragged_route,
    ragged_tiles_reference)

PAGE = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 12288),
                                   (8, 11008, 4096), (37, 256, 132),
                                   (8, 768, 2), (37, 256, 3),
                                   (1024, 768, 770),
                                   # StarCoder-15B's decode step: the
                                   # multi-query k/v (N = 128), fc_in
                                   # and fc_out (K = 24576, NeoX's too)
                                   (8, 6144, 128), (8, 6144, 24576),
                                   (8, 24576, 6144),
                                   # StarCoder's generate step (1 row)
                                   (1, 6144, 6144), (1, 6144, 128),
                                   (1, 6144, 24576), (1, 24576, 6144),
                                   # Bloom-7b1's generate step (4 rows)
                                   (4, 4096, 16384), (4, 16384, 4096)])
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


# the tensor-core route at every served prefill bucket at or above
# TC_MIN_M, Mistral's M = 2048, ragged M, K = 14336 (448 groups) and
# N = 28672; decided inside the test, never at import
TC_SHAPES = [(m, 4096, 4096) for m in (16, 32, 64, 128, 256, 512, 1024)] + [
    (2048, 4096, 6144), (100, 4096, 4096), (130, 4096, 12288),
    (2047, 4096, 4096), (256, 14336, 4096), (2048, 4096, 28672),
    (512, 11008, 4096), (1024, 768, 3072), (130, 96, 160),
    # StarCoder-15B's and GPT-NeoX-20B's prefill at bucket 512: the
    # multi-query k/v (N = 128) and fc_out (K = 24576)
    (512, 6144, 128), (512, 24576, 6144),
    # Bloom-7b1's generate prefill (4 x 512 rows): fc_in and fc_out
    (2048, 4096, 16384), (2048, 16384, 4096)]


@pytest.mark.parametrize("m,k,n", TC_SHAPES)
def test_int4_matmul_tc(cuda, m, k, n):
    """The tensor-core kernel against the plain version, f32 and bf16
    out, under the same tolerances as the GEMV: 2e-5 of max|y| for f32
    out (exact f32 products of bf16 x and q-8, f32 sums in another
    order), plus one bf16 ulp of max|y| for bf16 out. Shapes below
    ``TC_MIN_M`` take the GEMV and are covered above."""
    if matmul_route(m, n) != "tc":
        pytest.skip(f"M={m} < TC_MIN_M={TC_MIN_M}: the GEMV route")
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randint(0, 256, (k // 2, n), generator=g, device=cuda,
                      dtype=torch.uint8)
    s = torch.empty((k // 32, n), device=cuda).uniform_(0.001, 0.02,
                                                        generator=g)
    before = (int4_matmul.launches, int4_matmul.tc_launches)
    got = int4_matmul(x, q, s, out_dtype=torch.float32)
    got16 = int4_matmul(x, q, s)
    torch.cuda.synchronize()
    assert (int4_matmul.launches, int4_matmul.tc_launches) == (
        before[0] + 2, before[1] + 2)
    want = int4_matmul_reference(x, q, s, torch.float32)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale
    want16 = int4_matmul_reference(x, q, s, torch.bfloat16)
    err16 = (got16.float() - want16.float()).abs().max().item()
    assert err16 <= 1e-4 + 2.0 ** -7 * scale


@pytest.mark.parametrize("m,k,n", [(130, 96, 160), (2047, 4096, 4096),
                                   (1024, 768, 768), (16, 4096, 22016)])
def test_int4_matmul_tc_tiles_agree(cuda, m, k, n):
    """Every block shape of the tensor-core kernel gives the same bits
    (the same ``wgmma`` per 64 rows, the same rescale chain), in f32 and
    bf16 out; so the shape rule never changes a result."""
    from bigdl_tpu_torch.llm.kernels import _build
    from bigdl_tpu_torch.llm.kernels.int4_matmul import _launch
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randint(0, 256, (k // 2, n), generator=g, device=cuda,
                      dtype=torch.uint8)
    s = torch.rand((k // 32, n), generator=g, device=cuda) * 0.02
    for dt in (torch.float32, torch.bfloat16):
        outs = []
        for tile in ((128, 128), (64, 128), (64, 64)):
            o = torch.empty((m, n), device=cuda, dtype=dt)
            _build.check(_launch(int4_matmul, x, (q, s), o, "tc", None,
                                 tile), "tc")
            outs.append(o)
        assert all(torch.equal(outs[0], o) for o in outs[1:])
    want = int4_matmul_reference(x, q, s, torch.float32)
    scale = want.abs().max().item()
    assert (outs[0].float() - want).abs().max().item() <= (
        1e-4 + 2.0 ** -7 * scale)


@pytest.mark.parametrize("m,n,route", [
    (1, 4096, "gemv"), (8, 12288, "gemv"), (4, 28672, "gemv"),
    (TC_MIN_M - 1, 4096, "gemv"), (TC_MIN_M, 4096, "tc"),
    (512, 12288, "tc"), (2048, 28672, "tc"), (1024, 768, "tc"),
    (1024, 770, "gemv"), (8, 2, "gemv"), (4200, 6144, "tc")])
def test_int4_matmul_route_counters(cuda, m, n, route):
    """The route rule sends each shape where it says, and the counters
    show it: every call adds one to ``launches``, and one to
    ``tc_launches`` or ``gemv_launches`` by route."""
    assert matmul_route(m, n) == route
    x = torch.zeros((m, 64), device=cuda, dtype=torch.bfloat16)
    q = torch.zeros((32, n), device=cuda, dtype=torch.uint8)
    s = torch.zeros((2, n), device=cuda)
    before = (int4_matmul.launches, int4_matmul.tc_launches,
              int4_matmul.gemv_launches)
    int4_matmul(x, q, s)
    assert int4_matmul.launches == before[0] + 1
    assert int4_matmul.tc_launches == before[1] + (route == "tc")
    assert int4_matmul.gemv_launches == before[2] + (route == "gemv")


def _int4_row3(device, m, k=1024, n=256, first=0):
    """Row 3 of x times the weights, from a product of x's rows
    ``first .. first + m``."""
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((512, k), generator=g, device=device).to(torch.bfloat16)
    q = torch.randint(0, 256, (k // 2, n), generator=g, device=device,
                      dtype=torch.uint8)
    s = torch.rand((k // 32, n), generator=g, device=device) * 0.02
    return int4_matmul(x[first:first + m].contiguous(), q, s,
                       out_dtype=torch.float32)[3 - first]


@pytest.mark.parametrize("route", ["gemv", "tc"])
def test_int4_matmul_rows_independent(cuda, route):
    """The summation order of an output element does not depend on M
    within a route: on the GEMV row 3 of an M=``TC_MIN_M - 1`` product
    equals that row of M=4 and that row alone (M=1); on the tensor-core
    route row 3 of M=512 equals that row of M=``TC_MIN_M``, bit for
    bit."""
    if route == "tc":
        big, small = 512, TC_MIN_M
        assert matmul_route(big, 256) == matmul_route(small, 256) == "tc"
    else:
        big, small = TC_MIN_M - 1, 4
        assert matmul_route(big, 256) == matmul_route(small, 256) == "gemv"
        alone = _int4_row3(cuda, 1, first=3)
        assert torch.equal(_int4_row3(cuda, big), alone)
    assert torch.equal(_int4_row3(cuda, big), _int4_row3(cuda, small))


GEMV_KINDS = {"sym_int4": (int4_matmul, int4_matmul_reference),
              "asym_int4": (asym_int4_matmul, asym_int4_matmul_reference),
              "sym_int8": (int8_matmul, int8_matmul_reference)}


@pytest.mark.parametrize("kind", sorted(GEMV_KINDS))
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 15])
@pytest.mark.parametrize("k,n", [(768, 2), (768, 3), (768, 770),
                                 (4096, 4096), (4096, 12288),
                                 (11008, 4096), (14336, 4096)])
def test_gemv(cuda, kind, m, k, n):
    """The split-K GEMV (``csrc/lowbit_gemv.cu``) of each format against
    its plain version: 2e-5 of max|y| for f32 out (exact f32 products,
    f32 sums in another order), plus one bf16 ulp of max|y| for bf16
    out; one launch a call, on the GEMV."""
    fn, ref = GEMV_KINDS[kind]
    assert matmul_route(m, n) == "gemv"
    if kind == "sym_int4":
        g = torch.Generator(device=cuda).manual_seed(5)
        x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        planes = (torch.randint(0, 256, (k // 2, n), generator=g,
                                device=cuda, dtype=torch.uint8),
                  torch.rand((k // 32, n), generator=g, device=cuda) * 0.02)
    else:
        x, planes = _lowbit_inputs(kind, m, k, n, 5, cuda)
    before = fn.gemv_launches
    got = fn(x, *planes, out_dtype=torch.float32)
    got16 = fn(x, *planes)
    torch.cuda.synchronize()
    assert fn.gemv_launches == before + 2
    want = ref(x, *planes, torch.float32)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale
    err16 = (got16.float() - ref(x, *planes, torch.bfloat16).float()) \
        .abs().max().item()
    assert err16 <= 1e-4 + 2.0 ** -7 * scale


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
@pytest.mark.parametrize("route", ["gemv", "tc"])
def test_lowbit_matmul_rows_independent(cuda, kind, route):
    """The summation order of an output element does not depend on M
    within a route: on the tensor-core route row 3 of M=512 equals that
    row of M=``TC_MIN_M``; on the GEMV row 3 of M=15 equals that row of
    M=4 and that row alone, bit for bit."""
    fn, _ = LOWBIT[kind]
    big, small = (512, TC_MIN_M) if route == "tc" else (15, 4)
    assert matmul_route(big, 256) == matmul_route(small, 256) == route
    x, planes = _lowbit_inputs(kind, 512, 512, 256, 1, cuda)
    rows = [fn(x[:m].contiguous(), *planes, out_dtype=torch.float32)[3]
            for m in (big, small)]
    assert torch.equal(rows[0], rows[1])
    if route == "gemv":
        alone = fn(x[3:4].contiguous(), *planes, out_dtype=torch.float32)
        assert torch.equal(rows[0], alone[0])


# the tensor-core route of q4_1 and q8_0: BERT-base's M = 1024 linears,
# ragged M, K = 3072 and 96 (three groups), N = 16, 160 and 3072
LOWBIT_TC_SHAPES = [(1024, 768, 768), (1024, 768, 3072), (1024, 3072, 768),
                    (100, 768, 768), (130, 96, 160), (2047, 3072, 768),
                    (64, 96, 16), (512, 3072, 3072), (TC_MIN_M, 768, 3072)]


@pytest.mark.parametrize("kind", sorted(LOWBIT))
@pytest.mark.parametrize("m,k,n", LOWBIT_TC_SHAPES)
def test_lowbit_matmul_tc(cuda, kind, m, k, n):
    """The tensor-core kernels against the plain version, f32 and bf16
    out, under the CUDA-core kernel's tolerances: 2e-5 of max|y| for f32
    out (exact f32 products of bf16 x and the integer q, f32 rescales in
    another order), plus one bf16 ulp of max|y| for bf16 out. Each call
    one launch, on the tensor-core route."""
    fn, ref = LOWBIT[kind]
    assert matmul_route(m, n) == "tc"
    x, planes = _lowbit_inputs(kind, m, k, n, 3, cuda)
    before = (fn.launches, fn.tc_launches)
    got = fn(x, *planes, out_dtype=torch.float32)
    got16 = fn(x, *planes)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches) == (before[0] + 2, before[1] + 2)
    want = ref(x, *planes, torch.float32)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale
    err16 = (got16.float() - ref(x, *planes, torch.bfloat16).float()) \
        .abs().max().item()
    assert err16 <= 1e-4 + 2.0 ** -7 * scale


def _per_channel(planes):
    """The scale (and zero) planes as one row expanded over the groups
    (row stride 0)."""
    return (planes[0],) + tuple(p[:1].expand(p.shape[0], p.shape[1])
                                for p in planes[1:])


@pytest.mark.parametrize("kind,per_channel", [
    ("asym_int4", False), ("sym_int8", False), ("asym_int4", True),
    ("sym_int8", True)])
@pytest.mark.parametrize("m,k,n", [(130, 96, 160), (2047, 3072, 768),
                                   (1024, 768, 768), (16, 768, 3072)])
def test_lowbit_matmul_tc_tiles_agree(cuda, kind, per_channel, m, k, n):
    """Every block shape of the tensor-core kernels gives the same bits
    (the same ``wgmma`` per 64 rows, the same rescale chain), in f32 and
    bf16 out, also with a per-channel (stride-0) scale."""
    from bigdl_tpu_torch.llm.kernels import _build
    from bigdl_tpu_torch.llm.kernels.int4_matmul import _launch
    fn, ref = LOWBIT[kind]
    x, planes = _lowbit_inputs(kind, m, k, n, 7, cuda)
    if per_channel:
        planes = _per_channel(planes)
    lds = 0 if per_channel else n
    for dt in (torch.float32, torch.bfloat16):
        outs = []
        for tile in ((128, 128), (64, 128), (64, 64)):
            o = torch.empty((m, n), device=cuda, dtype=dt)
            _build.check(_launch(fn, x, planes, o, "tc", lds, tile), "tc")
            outs.append(o)
        assert all(torch.equal(outs[0], o) for o in outs[1:])
    want = ref(x, *planes, torch.float32)
    scale = want.abs().max().item()
    assert (outs[0].float() - want).abs().max().item() <= (
        1e-4 + 2.0 ** -7 * scale)


@pytest.mark.parametrize("kind", sorted(LOWBIT))
@pytest.mark.parametrize("m,n,route", [
    (8, 768, "gemv"), (8, 2, "gemv"), (TC_MIN_M - 1, 768, "gemv"),
    (TC_MIN_M, 768, "tc"), (1024, 768, "tc"), (1024, 3072, "tc"),
    (1024, 2, "gemv"), (1024, 130, "gemv"), (4200, 16, "tc")])
def test_lowbit_matmul_route_counters(cuda, kind, m, n, route):
    """The route rule sends each shape where it says, and the counters
    show it: every call adds one to ``launches``, the tensor-core route
    one to ``tc_launches`` as well; ``launch_counts()`` reports the
    latter as ``<wrapper>_tc``."""
    from bigdl_tpu_torch.llm import kernels
    fn, _ = LOWBIT[kind]
    assert matmul_route(m, n) == route
    x, planes = _lowbit_inputs(kind, m, 64, n, 4, cuda)
    before = (fn.launches, fn.tc_launches)
    fn(x, *planes)
    assert fn.launches == before[0] + 1
    assert fn.tc_launches == before[1] + (route == "tc")
    assert kernels.launch_counts()[f"{fn.__name__}_tc"] == fn.tc_launches


@pytest.mark.parametrize("kind", sorted(LOWBIT))
@pytest.mark.parametrize("n", [300, 768])
def test_int8_matmul_broadcast_scale(cuda, kind, n):
    """A per-channel scale (and q4_1 zero) expanded over the groups (row
    stride 0, as ``nn.quantized.Linear`` passes it) equals the
    materialised one bit for bit, on the GEMV (N = 300) and on the
    tensor-core route (N = 768), and the plain version within
    2e-5 of max|y|."""
    fn, ref = LOWBIT[kind]
    x, planes = _lowbit_inputs(kind, 40, 768, n, 2, cuda)
    view = _per_channel(planes)
    assert all(p.stride(0) == 0 for p in view[1:])
    tc = fn.tc_launches
    got = fn(x, *view, out_dtype=torch.float32)
    assert fn.tc_launches == tc + (matmul_route(40, n) == "tc")
    want = fn(x, *(p.contiguous() for p in view), out_dtype=torch.float32)
    assert torch.equal(got, want)
    plain = ref(x, *view, torch.float32)
    assert (got - plain).abs().max().item() <= 2e-5 * plain.abs().max().item()


@pytest.mark.parametrize("hq,hkv,d,win", [(32, 32, 128, None),
                                          (32, 8, 128, None),
                                          (32, 32, 64, None),
                                          (8, 2, 64, 40),
                                          # StarCoder-15B, GPT-NeoX-20B
                                          (48, 1, 128, None),
                                          (64, 64, 96, None)])
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


# the tensor-core route: the 7B main path (offset 0), Mistral's GQA with
# its window, GLM-4-9B's group of 16, offsets > 0 off the page and the
# tile, a served bucket below 64 rows, D = 64 / 80 / 16 (zero columns), a
# page of 8 (boxes of 8 rows), and the 7B prefix-cache and chunk offsets
TC_RAGGED = [  # (Hq, Hkv, D, offset, seq_len, Tq, window, page)
    (32, 32, 128, 0, 300, 512, None, 16), (32, 8, 128, 37, 200, 256, 4096, 16),
    (32, 8, 128, 300, 250, 256, 128, 16), (32, 2, 128, 0, 300, 512, None, 16),
    (32, 2, 128, 1000, 24, 32, None, 16), (32, 32, 64, 80, 60, 64, None, 16),
    (16, 2, 80, 45, 100, 128, 70, 8), (8, 1, 16, 3, 9, 16, None, 16),
    # the served prefix cache's and chunked prefill's offsets at 7B: a
    # cached-tail prefill behind a 1024-token prefix, a final 64-row chunk
    (32, 32, 128, 1024, 300, 512, None, 16),
    (32, 32, 128, 1472, 64, 64, None, 16),
    # speculative verify chunks at 7B: 2, 4 and 8 rows (some of them
    # padding) at offsets off the page and the tile
    (32, 32, 128, 17, 2, 2, None, 16), (32, 32, 128, 301, 3, 4, None, 16),
    (32, 32, 128, 301, 4, 4, None, 16), (32, 32, 128, 1001, 5, 8, None, 16),
    (32, 32, 128, 1001, 8, 8, None, 16),
    # the served prefills of StarCoder-15B (48 query heads on one K/V
    # head) and GPT-NeoX-20B (D = 96), a cached StarCoder suffix and a
    # StarCoder verify chunk
    (48, 1, 128, 0, 300, 512, None, 16), (64, 64, 96, 0, 300, 512, None, 16),
    (48, 1, 128, 1024, 300, 512, None, 16),
    (48, 1, 128, 301, 5, 8, None, 16)]


@pytest.mark.parametrize("hq,hkv,d,off,slen,tq,win,page", TC_RAGGED)
def test_ragged_prefill_attention_tc(cuda, hq, hkv, d, off, slen, tq, win,
                                     page):
    """bf16 q, pools and suffix K/V take the tensor-core kernel: valid rows
    within 2^-8 max|V| of both plain versions (P rounded to bf16, as the
    TPU kernel's DEFAULT-precision dots round it, relative error 2^-9 on
    a convex combination of V rows), padded rows 0, and one launch on
    each counter."""
    g = torch.Generator(device=cuda).manual_seed(9)
    maxp = -(-(off + 1) // page) + 2
    P = 3 + maxp
    q = torch.randn((1, tq, hq, d), generator=g, device=cuda).to(
        torch.bfloat16)
    ks, vs = (torch.randn((1, tq, hkv, d), generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    kp, vp = (torch.randn((P, hkv, page, d), generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    bt = (1 + torch.randperm(P - 1, generator=g, device=cuda)[:maxp]) \
        .reshape(1, maxp).to(torch.int32)
    offs = torch.tensor([off], dtype=torch.int32, device=cuda)
    lens = torch.tensor([slen], dtype=torch.int32, device=cuda)
    args = (q, ks, vs, kp, vp, bt, offs, lens)
    assert ragged_route(q, kp) == "tc"
    before = (ragged_prefill_attention.launches,
              ragged_prefill_attention.tc_launches)
    got = ragged_prefill_attention(*args, page_size=page, sliding_window=win)
    torch.cuda.synchronize()
    assert (ragged_prefill_attention.launches,
            ragged_prefill_attention.tc_launches) == (before[0] + 1,
                                                      before[1] + 1)
    tol = 2.0 ** -8 * max(vs.float().abs().max().item(),
                          vp.float().abs().max().item())
    for want in (ragged_prefill_reference(*args, sliding_window=win),
                 ragged_tiles_reference(*args, sliding_window=win)):
        assert (got[:, :slen] - want[:, :slen]).abs().max().item() <= tol
    assert torch.isfinite(got).all() and not got[:, slen:].any()


def test_ragged_prefill_route_counters(cuda):
    """f32 q or f32 pools, or D not a multiple of 16, take the CUDA-core
    kernel: ``launches`` counts every call, ``tc_launches`` only the
    tensor-core ones, and ``launch_counts()`` reports both."""
    from bigdl_tpu_torch.llm import kernels
    g = torch.Generator(device=cuda).manual_seed(10)
    for qt, kt, d, route in ((torch.bfloat16, torch.bfloat16, 64, "tc"),
                             (torch.float32, torch.bfloat16, 64,
                              "cuda_core"),
                             (torch.bfloat16, torch.float32, 64,
                              "cuda_core"),
                             (torch.bfloat16, torch.bfloat16, 40,
                              "cuda_core")):
        q = torch.randn((1, 16, 4, d), generator=g, device=cuda).to(qt)
        ks, vs = (torch.randn((1, 16, 2, d), generator=g, device=cuda)
                  .to(kt) for _ in range(2))
        kp, vp = (torch.randn((4, 2, PAGE, d), generator=g, device=cuda)
                  .to(kt) for _ in range(2))
        bt = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
        offs, lens = (torch.tensor([v], dtype=torch.int32, device=cuda)
                      for v in (20, 11))
        assert ragged_route(q, kp) == route
        kernels.reset_launch_counts()
        got = ragged_prefill_attention(q, ks, vs, kp, vp, bt, offs, lens,
                                       page_size=PAGE)
        counts = kernels.launch_counts()
        assert counts["ragged_prefill_attention"] == 1
        assert counts["ragged_prefill_attention_tc"] == (route == "tc")
        want = ragged_prefill_reference(q, ks, vs, kp, vp, bt, offs, lens)
        vmax = max(vs.float().abs().max().item(),
                   vp.float().abs().max().item())
        tol = 2.0 ** -8 * vmax if route == "tc" else 1e-3
        assert (got[:, :11] - want[:, :11]).abs().max().item() <= tol


# kernels 2 and 6 past the old limits: groups of 7 (Qwen2-7B), 16 (GLM-4-9B)
# and 48 (StarCoder's MQA), and D = 80, 96 (GPT-NeoX-20B) and 256; f32
# pools at D = 20 (4-wide vectors) and 256 (8-wide)
WIDE_PAGED = [  # (Hq, Hkv, D, window, pools)
    (28, 4, 128, None, "bf16"), (32, 2, 128, None, "bf16"),
    (48, 1, 128, 300, "bf16"), (32, 4, 80, None, "bf16"),
    (64, 8, 96, 200, "bf16"), (16, 2, 256, None, "bf16"),
    (16, 1, 20, None, "f32"), (16, 2, 256, 300, "f32")]


@pytest.mark.parametrize("hq,hkv,d,win,pools", WIDE_PAGED)
@pytest.mark.parametrize("normalize", [False, True])
def test_paged_attention_any_group_and_d(cuda, hq, hkv, d, win, pools,
                                         normalize):
    """Both entries at lengths across the split boundaries and a length-0
    row, against the plain versions (1e-3); the row alone equals the
    same row in the batch, bit for bit."""
    from bigdl_tpu_torch.llm.kernels.paged_attention import _decode_cuda
    g = torch.Generator(device=cuda).manual_seed(11)
    lens = [SPLIT_KEYS * 3 + 5, 0, 17, SPLIT_KEYS, 700, 1]
    maxp = -(-max(lens) // PAGE) + 1
    P = 1 + len(lens) * maxp
    q = torch.randn((len(lens), hq, d), generator=g, device=cuda)
    kp, vp = _pool(g, P, hkv, d, cuda)
    if pools == "f32":
        kp, vp = kp.float(), vp.float()
    bt = (1 + torch.randperm(P - 1, generator=g, device=cuda)[
        :len(lens) * maxp]).reshape(len(lens), maxp).to(torch.int32)
    ln = torch.tensor(lens, device=cuda, dtype=torch.int32)
    live = ln > 0
    got = _decode_cuda(q, kp, vp, bt, ln, win, normalize)
    alone = _decode_cuda(q[:1], kp, vp, bt[:1], ln[:1], win, normalize)
    torch.cuda.synchronize()
    if normalize:
        want = paged_attention_reference(q, kp, vp, bt, ln,
                                         sliding_window=win)
        assert (got[live] - want[live]).abs().max().item() < 1e-3
        assert torch.all(got[~live] == 0)
        assert torch.equal(alone, got[:1])
        return
    acc, m, l = got
    racc, rm, rl = paged_attention_reference_stats(q, kp, vp, bt, ln,
                                                   sliding_window=win)
    out = acc[live] / l[live][..., None]
    rout = racc[live] / rl[live][..., None]
    assert (out - rout).abs().max().item() < 1e-3
    assert (m - rm).abs().max().item() < 1e-3
    assert ((l - rl).abs() / rl.clamp(min=1)).max().item() < 1e-3
    assert torch.all(m[~live] == -1e30) and torch.all(acc[~live] == 0)
    assert all(torch.equal(a, b[:1]) for a, b in zip(alone, got))


def test_paged_attention_refuses_wide_rows(cuda):
    """D past 256, not a multiple of 8 (bf16), or past 128 and not a
    multiple of 8 (f32) raises, naming the limit."""
    g = torch.Generator(device=cuda).manual_seed(12)
    for d, dt in ((264, torch.bfloat16), (132, torch.float32),
                  (36, torch.bfloat16), (264, torch.float32)):
        kp, vp = (torch.randn((3, 1, PAGE, d), generator=g, device=cuda)
                  .to(dt) for _ in range(2))
        q = torch.randn((1, 2, d), generator=g, device=cuda)
        bt = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
        ln = torch.tensor([5], dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="Queue 3"):
            paged_attention_decode_stats(q, kp, vp, bt, ln, PAGE)


def _pool(g, P, hkv, d, device, lead=()):
    return (torch.randn(lead + (P, hkv, PAGE, d), generator=g,
                        device=device).to(torch.bfloat16) for _ in range(2))


@pytest.mark.parametrize("hq,hkv,d,win,lens", [
    (32, 32, 128, None, [1, 2, 15, 16, 17, 100, 255, 384]),   # MHA
    (32, 8, 128, None, [1, 33, 513, 576, 1000, 2049, 4000, 4233]),  # GQA
    (32, 8, 128, 4096, [1, 4095, 4096, 4097, 4200, 4233, 700, 9]),  # window
    (32, 32, 64, None, [1, 7, 64, 65, 300, 301, 1200, 4233]),  # D = 64
    (8, 2, 64, 40, [3, 39, 40, 41, 90, 1, 2, 333])])
def test_paged_attention_decode(cuda, hq, hkv, d, win, lens):
    """Kernel 6 against its plain version on bf16 pools and bf16 queries:
    f32 math on both sides, then one rounding to bf16 — within 1e-3 plus
    one bf16 ulp of max|out| (2^-7 of it). Exactly one launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, maxp = len(lens), -(-max(lens) // PAGE) + 3
    P = 1 + B * maxp
    q = torch.randn((B, hq, d), generator=g, device=cuda).to(torch.bfloat16)
    kp, vp = _pool(g, P, hkv, d, cuda)
    bt = (1 + torch.randperm(P - 1, generator=g, device=cuda)[:B * maxp]) \
        .reshape(B, maxp).to(torch.int32)
    ln = torch.tensor(lens, device=cuda, dtype=torch.int32)
    before = paged_attention_decode.launches
    got = paged_attention(q, kp, vp, bt, ln, page_size=PAGE,
                          sliding_window=win)
    torch.cuda.synchronize()
    assert paged_attention_decode.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = paged_attention_reference(q, kp, vp, bt, ln, sliding_window=win)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-3 + 2.0 ** -7 * scale


def _split_lens():
    """Lengths at the kernel's split boundaries: SPLIT_KEYS * j +- 1, one
    exactly at a boundary, 0, a short row and a long one."""
    S = SPLIT_KEYS
    return [S - 1, S, S + 1, 2 * S - 1, 2 * S + 1, 3 * S + 1, 0, 5]


@pytest.mark.parametrize("hq,hkv,win", [(32, 8, None), (32, 8, 300),
                                        (32, 32, None), (8, 2, SPLIT_KEYS)])
@pytest.mark.parametrize("normalize", [False, True])
def test_paged_attention_split_boundaries(cuda, hq, hkv, win, normalize):
    """Both entries at lengths on and next to the split boundaries, with
    windows that cut splits (300 starts inside one, SPLIT_KEYS starts on
    a boundary for some rows), a length-0 row and bf16 pools, against
    the plain versions under their unchanged tolerances (1e-3)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    lens = _split_lens()
    B, d = len(lens), 128
    maxp = -(-max(lens) // PAGE) + 2
    P = 1 + B * maxp
    q = torch.randn((B, hq, d), generator=g, device=cuda)
    kp, vp = _pool(g, P, hkv, d, cuda)
    bt = (1 + torch.randperm(P - 1, generator=g, device=cuda)[:B * maxp]) \
        .reshape(B, maxp).to(torch.int32)
    ln = torch.tensor(lens, device=cuda, dtype=torch.int32)
    live = ln > 0
    if normalize:
        got = paged_attention_decode(q, kp, vp, bt, ln, PAGE,
                                     sliding_window=win)
        want = paged_attention_reference(q, kp, vp, bt, ln,
                                         sliding_window=win)
        assert (got[live] - want[live]).abs().max().item() < 1e-3
        assert torch.all(got[~live] == 0)
        return
    acc, m, l = paged_attention_decode_stats(q, kp, vp, bt, ln, PAGE,
                                             sliding_window=win)
    racc, rm, rl = paged_attention_reference_stats(q, kp, vp, bt, ln,
                                                   sliding_window=win)
    out = acc[live] / l[live][..., None]
    rout = racc[live] / rl[live][..., None]
    assert (out - rout).abs().max().item() < 1e-3
    assert (m - rm).abs().max().item() < 1e-3
    assert ((l - rl).abs() / rl.clamp(min=1)).max().item() < 1e-3
    assert torch.all(m[~live] == -1e30) and torch.all(l[~live] == 0)
    assert torch.all(acc[~live] == 0)


@pytest.mark.parametrize("split_keys", [128, 256, 512])
def test_paged_attention_long_row_any_split(cuda, split_keys):
    """B=1 at 4233 keys, Mistral's GQA and window (4096): every split
    size the kernel takes gives the plain version's result (1e-3), and
    the row alone equals the same row inside a batch, bit for bit."""
    from bigdl_tpu_torch.llm.kernels.paged_attention import _decode_cuda
    g = torch.Generator(device=cuda).manual_seed(5)
    hq, hkv, d, win = 32, 8, 128, 4096
    lens = [4233, 17, 600]
    maxp = -(-max(lens) // PAGE) + 1
    P = 1 + len(lens) * maxp
    q = torch.randn((len(lens), hq, d), generator=g, device=cuda)
    kp, vp = _pool(g, P, hkv, d, cuda)
    bt = (1 + torch.arange(len(lens) * maxp, device=cuda)).reshape(
        len(lens), maxp).to(torch.int32)
    ln = torch.tensor(lens, device=cuda, dtype=torch.int32)
    got = _decode_cuda(q, kp, vp, bt, ln, win, True, split_keys)
    want = paged_attention_reference(q, kp, vp, bt, ln, sliding_window=win)
    assert (got - want).abs().max().item() < 1e-3
    alone = _decode_cuda(q[:1], kp, vp, bt[:1], ln[:1], win, True,
                         split_keys)
    assert torch.equal(alone, got[:1])


def test_paged_attention_decode_length_zero_is_zero(cuda):
    """The kernel follows the Pallas kernel: a row with length 0 is 0
    (the plain version follows the JAX reference: the mean of V)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    kp, vp = _pool(g, 9, 2, 64, cuda)
    q = torch.randn((2, 8, 64), generator=g, device=cuda)
    bt = torch.arange(1, 9, device=cuda, dtype=torch.int32).reshape(2, 4)
    ln = torch.tensor([0, 20], device=cuda, dtype=torch.int32)
    got = paged_attention_decode(q, kp, vp, bt, ln, page_size=PAGE)
    assert torch.all(got[0] == 0)
    want = paged_attention_reference(q, kp, vp, bt, ln)
    assert (got[1] - want[1]).abs().max().item() < 1e-3


@pytest.mark.parametrize("layer", [1, 3])
def test_paged_attention_stats_on_layer_views_split(cuda, layer):
    """The stats entry on a layer view of an (L, P, ...) pool at lengths
    that span several splits equals the plain version (1e-3)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    L, hq, hkv, d = 4, 32, 8, 128
    lens = [SPLIT_KEYS * 3 + 7, SPLIT_KEYS + 1]
    maxp = -(-max(lens) // PAGE) + 1
    P = 1 + len(lens) * maxp
    kp, vp = _pool(g, P, hkv, d, cuda, lead=(L,))
    q = torch.randn((len(lens), hq, d), generator=g, device=cuda)
    bt = (1 + torch.arange(len(lens) * maxp, device=cuda)).reshape(
        len(lens), maxp).to(torch.int32)
    ln = torch.tensor(lens, device=cuda, dtype=torch.int32)
    acc, m, l = paged_attention_decode_stats(q, kp[layer], vp[layer], bt, ln,
                                             PAGE, sliding_window=700)
    racc, rm, rl = paged_attention_reference_stats(
        q, kp[layer], vp[layer], bt, ln, sliding_window=700)
    assert (acc / l[..., None] - racc / rl[..., None]).abs().max() < 1e-3
    assert (m - rm).abs().max().item() < 1e-3


@pytest.mark.parametrize("layer", [1, 3])
def test_paged_attention_on_layer_views(cuda, layer):
    """``k_pages[l]`` of an (L, P, Hkv, page, D) pool is a contiguous view
    whose pointer is not the start of the allocation: kernel 6 on it
    equals the plain version, and equals stats over ``len - 1`` tokens
    (window shrunk by one) merged with token ``len - 1`` (1e-3, f32 q)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    L, B, hq, hkv, d, maxp, win = 4, 2, 32, 8, 128, 20, 150
    P = 1 + B * maxp
    kp, vp = _pool(g, P, hkv, d, cuda, lead=(L,))
    q = torch.randn((B, hq, d), generator=g, device=cuda)
    bt = (1 + torch.arange(B * maxp, device=cuda)).reshape(B, maxp).to(
        torch.int32)
    ln = torch.tensor([200, 317], device=cuda, dtype=torch.int32)
    kl, vl = kp[layer], vp[layer]
    assert kl.is_contiguous() and kl.data_ptr() != kp.data_ptr()
    got = paged_attention(q, kl, vl, bt, ln, page_size=PAGE,
                          sliding_window=win)
    want = paged_attention_reference(q, kl, vl, bt, ln, sliding_window=win)
    assert (got - want).abs().max().item() < 1e-3
    pos = (ln - 1).long()
    phys = bt[torch.arange(B, device=cuda), pos // PAGE].long()
    k_last = kl[phys, :, pos % PAGE]                       # (B, Hkv, D)
    v_last = vl[phys, :, pos % PAGE]
    st = paged_attention_decode_stats(q, kl, vl, bt, ln - 1, PAGE,
                                      sliding_window=win - 1)
    merged = merge_attention_partial(*st, q, k_last, v_last)
    assert (got - merged).abs().max().item() < 1e-3


def test_tiny_generate_card_vs_cpu(cuda):
    """``generate`` on the card (every int4_matmul and stats-kernel launch
    counted) against the port's plain path on the CPU, same f32 q4_0
    weights: the first step's logits within 2e-2 of their largest
    magnitude (the kernels read activations in bf16), and the launch
    counts exactly 4·L·(1 + n) and L·n."""
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM,
                                                  init_params,
                                                  quantize_params)
    cfg = LlamaConfig.tiny()
    params = quantize_params(init_params(cfg, 0, dtype=torch.float32,
                                         device="cpu"))
    ids = torch.randint(0, 256, (2, 24),
                        generator=torch.Generator().manual_seed(0)).numpy()
    cpu = LlamaForCausalLM(cfg, params, 64, torch.float32, device="cpu")
    card = LlamaForCausalLM(cfg, params, 64, torch.float32, device=cuda)
    lc, _ = cpu(ids)
    lg, _ = card(ids)
    rel = ((lg.cpu() - lc).abs().max() / lc.abs().max()).item()
    assert rel < 2e-2
    n, L = 8, cfg.num_hidden_layers
    kernels.reset_launch_counts()
    out = card.generate(ids, max_new_tokens=n)
    counts = kernels.launch_counts()
    assert counts["int4_matmul"] == 4 * L * (1 + n)
    # the prefill's 2 x 24 = 48 rows take the tensor-core route when
    # TC_MIN_M allows it and N % 16 == 0; decode (2 rows) never does
    tc_prefill = 4 * L if matmul_route(48, 16) == "tc" else 0
    assert counts["int4_matmul_tc"] == tc_prefill
    assert counts["paged_attention_decode_stats"] == L * n
    assert out.shape == (2, 24 + n) and out.max() < 256
    card.paged_decode = False
    kernels.reset_launch_counts()
    dense = card.generate(ids, max_new_tokens=n)
    assert kernels.launch_counts()["paged_attention_decode_stats"] == 0
    assert dense.shape == out.shape


def test_tiny_gqa16_served_alone_equals_batched(cuda):
    """A tiny model with GLM-4-9B's group (16 query heads on one kv head)
    served on the card: the paged decode kernel at g = 16 and the ragged
    prefill kernel on both routes' counters; one request served alone on
    a fresh server gives the tokens it got in a batch of three."""
    import dataclasses
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM)
    from bigdl_tpu_torch.llm.serving import LLMServer
    cfg = dataclasses.replace(LlamaConfig.tiny_glm(), hidden_size=256,
                              num_attention_heads=16, num_key_value_heads=1)
    model = LlamaForCausalLM.synthetic_q4(cfg, device=cuda, seed=4)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (n,), generator=gen).numpy()
               for n in (9, 40, 23)]

    def serve(ps):
        srv = LLMServer(model, max_batch=4, max_seq_len=96,
                        page_size=16).start()
        try:
            return [r.get(timeout=600) for r in
                    [srv.submit(p, max_new_tokens=12) for p in ps]]
        finally:
            srv.stop()

    kernels.reset_launch_counts()
    batched = serve(prompts)
    counts = kernels.launch_counts()
    L = cfg.num_hidden_layers
    assert counts["ragged_prefill_attention_tc"] == 3 * L
    assert counts["ragged_prefill_attention"] == 3 * L
    assert counts["paged_attention_decode_stats"] > 0
    assert all(len(t) == 12 and max(t) < 256 for t in batched)
    assert serve(prompts[1:2]) == batched[1:2]


def _tiny_card_model(cuda):
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM)
    return LlamaForCausalLM.synthetic_q4(LlamaConfig.tiny(), device=cuda,
                                         seed=6)


def _tiny_moe_card_model(cuda, factor):
    """tiny_moe at expert capacity ``factor``, random bf16 weights made on
    the card (MoE experts stay bf16, as in the JAX package)."""
    import dataclasses
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM,
                                                  init_params)
    cfg = dataclasses.replace(LlamaConfig.tiny_moe(),
                              expert_capacity_factor=factor)
    return LlamaForCausalLM(cfg, init_params(cfg, 6, device=cuda),
                            device=cuda)


def test_captured_served_step_equals_eager(cuda):
    """The served decode step as one CUDA graph against the eager
    ``paged_decode_step_sampled`` on copies of the same buffers: tokens,
    logits, lengths and pools bit for bit over 6 steps (the first eager,
    the rest replays; lengths 13 and 15 cross a page, one row inactive).
    The counters read 6 steps' launches: the warm-up's from Python, each
    replay's as the capture's delta."""
    _captured_decode_check(_tiny_card_model(cuda), cuda)


def _family_steps(model):
    """The sampled decode, mixed and verify steps of ``model``'s family,
    as the engine picks them."""
    from bigdl_tpu_torch.llm.serving import family_steps
    fam = family_steps(model)
    return fam["sampled_step"], fam["mixed_step"], fam["spec_step"]


def _captured_decode_check(model, cuda):
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.serving import bind_decode_step
    paged_decode_step_sampled = _family_steps(model)[0]
    cfg, B, cap = model.config, 4, 4
    g = torch.Generator(device=cuda).manual_seed(7)
    shape = (cfg.num_hidden_layers, 1 + B * cap, cfg.num_key_value_heads,
             PAGE, cfg.head_dim)
    st = {"kp": torch.randn(shape, generator=g, device=cuda).bfloat16(),
          "vp": torch.randn(shape, generator=g, device=cuda).bfloat16(),
          "bt": (1 + torch.arange(B * cap, device=cuda)).reshape(
              B, cap).int(),
          "lens": torch.tensor([13, 15, 30, 0], dtype=torch.int32,
                               device=cuda),
          "last": torch.randn((B, cfg.vocab_size), generator=g,
                              device=cuda),
          "active": torch.tensor([True, True, True, False], device=cuda),
          "toks": torch.zeros(B, dtype=torch.int32, device=cuda)}
    eager = {k: v.clone() for k, v in st.items()}
    step = CapturedStep(bind_decode_step(
        model.params, cfg, *(st[k] for k in (
            "kp", "vp", "bt", "lens", "last", "active", "toks")),
        page=PAGE, fam_step=paged_decode_step_sampled), cuda)
    n, seen = 6, []
    kernels.reset_launch_counts()
    for _ in range(n):
        step()
        seen.append({k: st[k].clone() for k in ("toks", "last", "lens")})
    counts = kernels.launch_counts()
    assert step.graph is not None and step.replays == n - 1
    assert step.launches["paged_attention_decode_stats"] == \
        cfg.num_hidden_layers
    assert {k: v for k, v in counts.items() if v} == {
        k: n * v for k, v in step.launches.items()}
    e = eager
    for want in seen:
        toks, logits, _, _, lens = paged_decode_step_sampled(
            model.params, cfg, e["kp"], e["vp"], e["bt"], e["lens"],
            e["last"], e["active"], page=PAGE)
        e["last"], e["lens"] = logits, lens
        assert torch.equal(toks, want["toks"])
        assert torch.equal(logits, want["last"])
        assert torch.equal(lens, want["lens"])
    assert torch.equal(e["kp"], st["kp"]) and torch.equal(e["vp"], st["vp"])


def _serve_tiny(model, prompts, n, **kw):
    from bigdl_tpu_torch.llm.serving import LLMServer
    srv = LLMServer(model, max_batch=2, max_seq_len=64, page_size=PAGE,
                    device=model.device, **kw).start()
    try:
        return [r.get(timeout=600) for r in
                [srv.submit(p, max_new_tokens=n) for p in prompts]], srv
    finally:
        srv.stop()


def test_served_depths_equal_generate(cuda):
    """Greedy tokens served through the graphed step at depth 2 equal
    depth 1 and each request's own ``generate`` (tiny, bf16), and the
    graph is freed with its server."""
    model = _tiny_card_model(cuda)
    gen = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, 256, (k,), generator=gen).numpy()
               for k in (5, 17, 9, 30)]
    want = [model.generate(p[None], max_new_tokens=10)[0, len(p):].tolist()
            for p in prompts]
    d2, srv = _serve_tiny(model, prompts, 10)
    assert srv.pipeline_depth == 2 and srv._decode.graph is None
    assert srv._decode.capture_seconds > 0 and srv.errors == []
    d1, _ = _serve_tiny(model, prompts, 10, pipeline_depth=1)
    assert d2 == d1 == want


def test_sampled_graph_draws_new_noise(cuda):
    """Sampling inside the graph: at a temperature that flattens the
    logits, a token is the argmax of the noise, so replays that drew the
    capture's noise again would repeat one token. The same seed gives
    the same tokens, served and through ``generate``."""
    model = _tiny_card_model(cuda)
    prompt = [torch.arange(1, 12).numpy()]
    runs = [_serve_tiny(model, prompt, 16, temperature=1e4,
                        sample_seed=3)[0][0] for _ in range(2)]
    assert runs[0] == runs[1] and len(set(runs[0][2:])) > 4
    outs = [model.generate(prompt[0][None], max_new_tokens=16,
                           do_sample=True, temperature=1e4, seed=3)[0, 11:]
            for _ in range(2)]
    assert outs[0].tolist() == outs[1].tolist()
    assert len(set(outs[0][2:].tolist())) > 4


def _mixed_state(model, cuda, B=4, cap=8, extra=8):
    cfg = model.config
    g = torch.Generator(device=cuda).manual_seed(11)
    shape = (cfg.num_hidden_layers, 1 + B * cap + extra,
             cfg.num_key_value_heads, PAGE, cfg.head_dim)
    return {"kp": torch.randn(shape, generator=g, device=cuda).bfloat16(),
            "vp": torch.randn(shape, generator=g, device=cuda).bfloat16(),
            "bt": (1 + torch.arange(B * cap, device=cuda)).reshape(
                B, cap).int(),
            "lens": torch.tensor([13, 15, 30, 0], dtype=torch.int32,
                                 device=cuda),
            "last": torch.randn((B, cfg.vocab_size), generator=g,
                                device=cuda),
            "active": torch.tensor([True, True, True, False], device=cuda),
            "toks": torch.zeros(B, dtype=torch.int32, device=cuda)}


def test_captured_mixed_step_equals_eager(cuda):
    """The mixed step of one chunk bucket as one CUDA graph
    (``bind_mixed_step``) against the eager ``paged_step_mixed`` on
    copies of the same buffers, over 4 passes whose chunk operands change
    in the persistent operand buffer (offsets 0..48 of a 60-token prompt
    in chunks of 16, a COW fork at the first): tokens, logits, ``clast``,
    lengths and pools bit for bit; one capture, every later pass a
    replay whose launches the counters read."""
    _captured_mixed_check(_tiny_card_model(cuda), cuda)


def _captured_mixed_check(model, cuda):
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.serving import (bind_mixed_step, chunk_operands,
                                             prefill_operands)
    paged_step_mixed = _family_steps(model)[1]
    cfg, cap, bucket = model.config, 8, 16
    st = _mixed_state(model, cuda, cap=cap)
    st["ops"] = torch.zeros(3 * bucket + 4 + cap, dtype=torch.int32,
                            device=cuda)
    st["clast"] = torch.zeros(cfg.vocab_size, device=cuda)
    e = {k: v.clone() for k, v in st.items()}
    step = CapturedStep(bind_mixed_step(
        model.params, cfg, *(st[k] for k in (
            "kp", "vp", "bt", "lens", "last", "active", "toks", "ops",
            "clast")), bucket=bucket, page=PAGE, fam_step=paged_step_mixed),
        cuda)
    ids = torch.randint(0, cfg.vocab_size, (60,),
                        generator=torch.Generator().manual_seed(1)).numpy()
    rows = list(range(33, 37))
    kernels.reset_launch_counts()
    for k in range(4):
        off = 16 * k
        ops = torch.from_numpy(prefill_operands(
            ids, off, min(off + 16, 60), bucket, rows, page=PAGE,
            pages_cap=cap, fork_dst=33 if k == 0 else 0,
            fork_src=5 if k == 0 else 0)).to(cuda)
        st["ops"].copy_(ops)
        step()
        toks, logits, _, _, lens, clast = paged_step_mixed(
            model.params, cfg, e["kp"], e["vp"], e["bt"], e["lens"],
            e["last"], e["active"], 1.0, None,
            *chunk_operands(ops, bucket, cap), page=PAGE)
        e["last"], e["lens"] = logits, lens
        assert torch.equal(toks, st["toks"]) and torch.equal(
            logits, st["last"]) and torch.equal(lens, st["lens"])
        assert torch.equal(clast, st["clast"])
    assert torch.equal(e["kp"], st["kp"]) and torch.equal(e["vp"], st["vp"])
    assert step.graph is not None and step.replays == 3
    L = cfg.num_hidden_layers
    assert step.launches["ragged_prefill_attention_tc"] == L
    assert step.launches["paged_attention_decode_stats"] == L
    # 4 steps (1 eager, 3 replays) and the 4 eager passes beside them
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        k: 8 * v for k, v in step.launches.items()}


def _serve_inline(srv, prompts, n, late, late_n):
    """Serve ``prompts`` inline; once each has 2 tokens, submit ``late``.
    Returns the requests, ``late``'s, and its first-token logits, read
    from ``_last`` right after its prefill (whole or final chunk)."""
    reqs = [srv.submit(p, max_new_tokens=n) for p in prompts]
    lr, first = None, None

    def read_first():
        i = srv._slots.index(lr) if lr in srv._slots else -1
        return srv._last[i].clone() if first is None and i >= 0 and \
            srv._remaining[i] == late_n else first

    while lr is None or not all(r.done.is_set() for r in reqs + [lr]):
        srv._admit()
        first = read_first()
        if lr is None and all(len(r.tokens) >= 2 for r in reqs):
            lr = srv.submit(late, max_new_tokens=late_n)
            continue
        srv._step_paged()
        first = read_first()
    while srv._inflight:
        srv._drain_next()
    return reqs, lr, first


def test_mixed_decode_rows_equal_split(cuda):
    """A 100-token prompt arrives while 3 rows decode: served mixed (in
    7 chunks of 16, fused with the decode rows) the 3 rows' tokens equal
    the split engine's bit for bit, the late request's first-token
    logits agree within 2e-2 of their largest magnitude, and bucket 16's
    graph is captured once and replayed by the later mixed passes."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    model = _tiny_card_model(cuda)
    gen = torch.Generator().manual_seed(12)
    prompts = [torch.randint(0, 256, (k,), generator=gen).numpy()
               for k in (5, 12, 9)]
    late = torch.randint(0, 256, (100,), generator=gen).numpy()
    out = {}
    for mixed in (False, True):
        srv = LLMServer(model, max_batch=4, max_seq_len=160, page_size=PAGE,
                        mixed=mixed, chunk_tokens=16, device=cuda)
        reqs, _, first = _serve_inline(srv, prompts, 24, late, 4)
        steps = {b: st[0].replays for b, st in srv._mixed_steps.items()}
        out[mixed] = ([r.tokens for r in reqs], first,
                      srv.prefill_chunks_total, srv.mixed_passes, steps)
        srv.stop()
        assert srv.errors == [] and srv._budget_avail == srv._num_pages - 1
    (toks0, f0, c0, m0, g0), (toks1, f1, c1, m1, g1) = out[False], out[True]
    assert toks0 == toks1
    assert (f0 - f1).abs().max().item() <= 2e-2 * f0.abs().max().item()
    assert (c0, m0, g0) == (0, 0, {}) and (c1, m1) == (7, 7)
    assert g1 == {16: 6}             # call 1 eager, call 2 captures


def test_prefix_cache_served_on_card(cuda):
    """The prefix cache on the card: 4 requests sharing a 48-token prefix
    (3 pages), 3 of them hits with 48 tokens reused each, greedy tokens
    equal to the cache-off engine's (tiny, bf16: the prefix-split prefill
    sums keys in another order, so this holds on a small model only)."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    model = _tiny_card_model(cuda)
    gen = torch.Generator().manual_seed(13)
    shared = torch.randint(0, 256, (48,), generator=gen)
    prompts = [torch.cat([shared, torch.randint(0, 256, (k,),
                                                generator=gen)]).numpy()
               for k in (3, 11, 20, 33)]
    outs = {}
    for kv in (False, True):
        srv = LLMServer(model, max_batch=4, max_seq_len=128, page_size=PAGE,
                        kvcache=kv, device=cuda)
        reqs = [srv.submit(p, max_new_tokens=8) for p in prompts]
        while not all(r.done.is_set() for r in reqs):
            srv._admit()
            srv._step_paged()
        outs[kv] = [r.tokens for r in reqs]
        if kv:
            assert srv._kv.hits == 3 and srv.prefix_tokens_saved == 3 * 48
        srv.stop()
    assert outs[True] == outs[False]


def test_sampled_mixed_and_decode_graphs_share_one_generator(cuda):
    """Sampling in two graphs (the decode step's and a mixed bucket's),
    both registered with the server's generator: replays draw new noise
    (at a temperature that flattens the logits a token is the noise's
    argmax) and the same seed gives the same tokens."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    model = _tiny_card_model(cuda)
    gen = torch.Generator().manual_seed(14)
    prompts = [torch.randint(0, 256, (k,), generator=gen).numpy()
               for k in (5, 9)]
    late = torch.randint(0, 256, (80,), generator=gen).numpy()
    runs = []
    for _ in range(2):
        srv = LLMServer(model, max_batch=4, max_seq_len=128, page_size=PAGE,
                        mixed=True, chunk_tokens=16, temperature=1e4,
                        sample_seed=3, device=cuda)
        reqs, lr, _ = _serve_inline(srv, prompts, 24, late, 8)
        assert srv.mixed_passes >= 3 and srv._mixed_steps[16][0].replays
        runs.append([r.tokens for r in reqs + [lr]])
        srv.stop()
    assert runs[0] == runs[1]
    assert all(len(set(t[2:])) > 3 for t in runs[0][:2])


@pytest.mark.parametrize("bucket", [2, 4, 8])
def test_captured_spec_step_equals_eager(cuda, bucket):
    """The verify step of one draft bucket as one CUDA graph
    (``bind_spec_step``) against the eager ``paged_step_spec`` on copies
    of the same buffers, over 4 passes whose operands change in the
    persistent buffer (row 2 verifying at its growing length, its
    drafts the eager pass's own greedy tokens so some are accepted):
    output ids, ``n_acc``, logits, lengths and every real page bit for
    bit; one
    capture, every later pass a replay whose launches the counters
    read."""
    _captured_spec_check(_tiny_card_model(cuda), cuda, bucket)


def _captured_spec_check(model, cuda, bucket):
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.serving import (bind_spec_step, spec_operands,
                                             verify_operands)
    paged_step_spec = _family_steps(model)[2]
    cfg, cap, B = model.config, 8, 4
    st = _mixed_state(model, cuda, cap=cap)
    st["active"][2] = False                  # the verify row sits out
    st["ops"] = torch.zeros(2 + 3 * bucket + cap, dtype=torch.int32,
                            device=cuda)
    st["sout"] = torch.zeros(B + 1 + bucket, dtype=torch.int32,
                             device=cuda)
    e = {k: v.clone() for k, v in st.items()}
    step = CapturedStep(bind_spec_step(
        model.params, cfg, *(st[k] for k in (
            "kp", "vp", "bt", "lens", "last", "active", "sout", "ops")),
        bucket=bucket, page=PAGE, fam_step=paged_step_spec), cuda)
    bt_row = st["bt"][2].cpu().numpy()
    accepted = 0
    kernels.reset_launch_counts()
    for k in range(4):
        pos0 = int(e["lens"][2])
        g = int(e["last"][2].argmax())
        ops = torch.from_numpy(verify_operands(
            2, [g] * (bucket - 1), pos0, bucket, bt_row, page=PAGE)).to(cuda)
        st["ops"].copy_(ops)
        step()
        out, logits, _, _, lens = paged_step_spec(
            model.params, cfg, e["kp"], e["vp"], e["bt"], e["lens"],
            e["last"], e["active"], 1.0, None,
            *spec_operands(ops, bucket, cap), page=PAGE)
        e["last"], e["lens"] = logits, lens
        assert torch.equal(out, st["sout"]) and torch.equal(
            logits, st["last"]) and torch.equal(lens, st["lens"])
        n_acc = int(out[B])
        assert 1 <= n_acc <= bucket and int(lens[2]) == pos0 + n_acc
        accepted += n_acc - 1
    # every real page; trash page 0 takes the two inactive rows' dummy
    # writes at one slot, in either order
    assert torch.equal(e["kp"][:, 1:], st["kp"][:, 1:])
    assert torch.equal(e["vp"][:, 1:], st["vp"][:, 1:])
    assert step.graph is not None and step.replays == 3
    L = cfg.num_hidden_layers
    assert step.launches["ragged_prefill_attention_tc"] == L
    assert step.launches["paged_attention_decode_stats"] == L
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        k: 8 * v for k, v in step.launches.items()}
    print(f"bucket {bucket}: {accepted} drafts accepted over 4 passes")


def _verify_vs_decode(model, cuda, pos0, w, live):
    """The verify leg (``paged_prefill_ragged(full_logits=True)``) on
    ``live`` of ``w`` chunk tokens at offset ``pos0`` over a random
    cached prefix, against ``live`` paged decode steps feeding the same
    tokens one by one on a copy of the pools. Returns the chunk logits
    and the largest gap relative to the largest decode logit."""
    from bigdl_tpu_torch.llm.models.llama import paged_prefill_ragged
    from bigdl_tpu_torch.llm.serving import paged_decode_step
    cfg = model.config
    cap = -(-(pos0 + w) // PAGE)
    g = torch.Generator(device=cuda).manual_seed(pos0)
    shape = (cfg.num_hidden_layers, 1 + cap, cfg.num_key_value_heads, PAGE,
             cfg.head_dim)
    kp = torch.randn(shape, generator=g, device=cuda).bfloat16()
    vp = torch.randn(shape, generator=g, device=cuda).bfloat16()
    bt = torch.arange(1, 1 + cap, dtype=torch.int32, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, w), generator=g,
                         device=cuda, dtype=torch.int32)
    pos = pos0 + torch.arange(w, device=cuda)
    phys = torch.where(pos < pos0 + live, bt[pos // PAGE],
                       torch.zeros_like(bt[pos // PAGE]))
    kd, vd = kp.clone(), vp.clone()
    with torch.inference_mode():
        _, _, chunk = paged_prefill_ragged(
            model.params, cfg, kp, vp, toks, live, pos0, bt, phys.int(),
            (pos % PAGE).int(), 0, 0, page=PAGE, full_logits=True)
        steps = [paged_decode_step(
            model.params, cfg, kd, vd, bt[None],
            torch.tensor([pos0 + j], dtype=torch.int32, device=cuda),
            toks[0, j:j + 1], page=PAGE)[0][0] for j in range(live)]
    want = torch.stack(steps)
    gap = ((chunk[:live] - want).abs().max() / want.abs().max()).item()
    return chunk, gap


@pytest.mark.parametrize("pos0,w,live", [(17, 2, 2), (301, 4, 3),
                                         (1001, 8, 8)])
def test_verify_leg_equals_stepwise_decode(cuda, pos0, w, live):
    """Teacher-forced at tiny width and at Llama-2-7B width cut to 2
    layers: every live chunk row's logits within 2e-2 of the largest
    magnitude of step-by-step paged decode's at the same positions (the
    two attention kernels sum in other orders), and every row finite,
    padded rows included (``spec_accept`` reads them)."""
    import dataclasses
    from bigdl_tpu_torch.llm.models.llama import LlamaConfig, LlamaForCausalLM
    for model in (_tiny_card_model(cuda), LlamaForCausalLM.synthetic_q4(
            dataclasses.replace(LlamaConfig.llama2_7b(), num_hidden_layers=2),
            device=cuda, seed=3)):
        chunk, gap = _verify_vs_decode(model, cuda, pos0, w, live)
        assert chunk.shape == (w, model.config.vocab_size)
        assert chunk.dtype == torch.float32 and torch.isfinite(chunk).all()
        assert gap <= 2e-2, gap
        del model


def test_served_spec_and_priority_on_card(cuda):
    """Speculation and preemption served on the card (tiny, bf16):
    in-vocab tokens, the ledger whole, every pass emitting ``g0`` and its
    accepted drafts, each draft bucket's graph captured once and
    replayed after; a preempted batch request resumes, its tokens up to
    the preemption equal to its run without priority."""
    import numpy as np
    from bigdl_tpu_torch.llm.serving import LLMServer
    model = _tiny_card_model(cuda)
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(15)
    pattern = torch.randint(0, V, (6,), generator=gen)
    prompts = [pattern.repeat(8).numpy(),
               torch.randint(0, V, (9,), generator=gen).numpy()]
    srv = LLMServer(model, max_batch=2, max_seq_len=128, page_size=PAGE,
                    spec=True, spec_k=8, device=cuda).start()
    try:
        outs = [r.get(timeout=600) for r in
                [srv.submit(p, max_new_tokens=40) for p in prompts]]
        graphs = {b: (st.calls, st.replays, st.graph is not None)
                  for b, (st, _, _) in srv._spec_steps.items()}
    finally:
        srv.stop()
    assert srv.errors == [] and srv.spec_passes > 0
    assert all(len(o) == 40 and all(0 <= t < V for t in o) for o in outs)
    assert srv.spec_emitted_total == srv.spec_passes + srv.spec_accepted_total
    assert srv._budget_avail == srv._num_pages - 1 and srv.pages_in_use == 0
    assert sum(c for c, _, _ in graphs.values()) == srv.spec_passes
    for calls, replays, captured in graphs.values():
        assert (captured, replays) == (calls > 1, max(calls - 1, 0))
    batch = [torch.randint(0, V, (k,), generator=gen).numpy()
             for k in (7, 12)]
    inter = torch.randint(0, V, (10,), generator=gen).numpy()
    runs = {}
    for pri in (False, True):
        srv = LLMServer(model, max_batch=2, max_seq_len=64, page_size=PAGE,
                        priority=pri, kvcache=True, device=cuda)
        rb = [srv.submit(p, 24, "batch") for p in batch]
        ri, n = None, 0
        while ri is None or not all(r.done.is_set() for r in rb + [ri]):
            srv._admit()
            if ri is None and n == 6:
                ri = srv.submit(inter, 4, "interactive")
            srv._step_paged()
            n += 1
        runs[pri] = ([r.tokens for r in rb], [r.resume_ids for r in rb],
                     srv.preemptions_total, srv.preempt_resumes_total)
        assert srv.errors == [] and srv._budget_avail == srv._num_pages - 1
        srv.stop()
    toks, resume, pre, res = runs[True]
    assert pre >= 1 and res == pre and runs[False][2] == 0
    for j, r in enumerate(resume):
        if r is not None:
            k = len(r) - len(batch[j])        # tokens before the preemption
            assert toks[j][:k] == runs[False][0][j][:k]
        assert all(0 <= t < V for t in toks[j]) and len(toks[j]) == 24
    assert any(r is not None for r in resume)
    assert np.all([len(t) == 24 for t in runs[False][0]])


@pytest.mark.parametrize("factor", [1.25, 0.0])
def test_captured_moe_steps_equal_eager(cuda, factor):
    """The decode, mixed and verify steps of a tiny MoE model (bf16
    experts, capacity mode and no-drop mode) as CUDA graphs against
    their eager steps, bit for bit on every real page: the routing and
    the capacity dispatch are device ops, capture-safe."""
    model = _tiny_moe_card_model(cuda, factor)
    _captured_decode_check(model, cuda)
    _captured_mixed_check(model, cuda)
    for bucket in (2, 8):
        _captured_spec_check(model, cuda, bucket)


@pytest.mark.parametrize("factor", [1.25, 0.0])
def test_tiny_moe_card_vs_cpu(cuda, factor):
    """tiny_moe, the same f32 weights on the card and on the CPU: the
    prefill logits of two 24-token rows within 2e-2 of their largest
    magnitude, and ``generate`` on the card with one stats kernel a
    layer a step (paged) and none dense."""
    import dataclasses
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM,
                                                  init_params)
    cfg = dataclasses.replace(LlamaConfig.tiny_moe(),
                              expert_capacity_factor=factor)
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    ids = torch.randint(0, 256, (2, 24),
                        generator=torch.Generator().manual_seed(0)).numpy()
    cpu = LlamaForCausalLM(cfg, params, 64, torch.float32, device="cpu")
    card = LlamaForCausalLM(cfg, params, 64, torch.float32, device=cuda)
    lc, _ = cpu(ids)
    lg, _ = card(ids)
    assert ((lg.cpu() - lc).abs().max() / lc.abs().max()).item() < 2e-2
    n, L = 8, cfg.num_hidden_layers
    for paged in (True, False):
        card.paged_decode = paged
        kernels.reset_launch_counts()
        out = card.generate(ids, max_new_tokens=n)
        assert kernels.launch_counts()["paged_attention_decode_stats"] == \
            (L * n if paged else 0)
        assert out.shape == (2, 24 + n) and out.max() < 256


def test_captured_slotted_step_equals_eager(cuda):
    """The slot-static decode step as one CUDA graph
    (``bind_slotted_step``) against the eager ``slotted_decode_step`` on
    copies of the same buffers over 6 steps: tokens, logits, positions
    and the cache bit for bit; one row inactive and one at the end of
    its window (it writes nothing)."""
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.kernels.sampling import sample_tokens
    from bigdl_tpu_torch.llm.models.llama import init_cache
    from bigdl_tpu_torch.llm.serving import (bind_slotted_step,
                                             slotted_decode_step)
    model = _tiny_card_model(cuda)
    cfg, B, S = model.config, 4, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    cache = init_cache(cfg, B, S, device=cuda)
    for t in cache["k"], cache["v"]:
        t.normal_(generator=g)
    st = {"k": cache["k"], "v": cache["v"],
          "pos": torch.tensor([13, 40, S, 5], dtype=torch.int32,
                              device=cuda),
          "last": torch.randn((B, cfg.vocab_size), generator=g,
                              device=cuda),
          "active": torch.tensor([True, True, False, False], device=cuda),
          "toks": torch.zeros(B, dtype=torch.int32, device=cuda)}
    e = {k: v.clone() for k, v in st.items()}
    step = CapturedStep(bind_slotted_step(model.params, cfg, *(st[k] for k in (
        "k", "v", "pos", "last", "active", "toks"))), cuda)
    for _ in range(6):
        step()
        t = sample_tokens(e["last"])
        e["last"] = slotted_decode_step(model.params, cfg, e["k"], e["v"],
                                        e["pos"], t)
        e["pos"] = e["pos"] + e["active"].to(torch.int32)
        assert torch.equal(t, st["toks"]) and torch.equal(
            e["last"], st["last"]) and torch.equal(e["pos"], st["pos"])
    assert step.graph is not None and step.replays == 5
    assert torch.equal(e["k"], st["k"]) and torch.equal(e["v"], st["v"])
    assert e["pos"].tolist() == [19, 46, S, 5]


def test_served_moe_and_slotted_on_card(cuda):
    """The engine on the card: tiny_moe (no-drop mode: a row's experts
    do not depend on the other rows, whatever the thread's schedule)
    served at depths 2 and 1 and tiny q4_0 on the slot-static engine at
    depths 2 and 1, through their captured decode steps: every request
    completes with in-vocab tokens, the same at both depths."""
    prompts = [torch.randint(0, 256, (k,), generator=torch.Generator()
                             .manual_seed(k)).numpy() for k in (5, 17, 30)]
    for model, kw in ((_tiny_moe_card_model(cuda, 0.0), {}),
                      (_tiny_card_model(cuda), {"paged": False})):
        runs = [_serve_tiny(model, prompts, 10, pipeline_depth=d, **kw)
                for d in (2, 1)]
        for toks, srv in runs:
            assert srv.errors == [] and srv._decode.capture_seconds > 0
            assert all(len(t) == 10 and max(t) < 256 for t in toks)
        assert runs[0][0] == runs[1][0]


def test_kvtier_on_card(cuda):
    """The host KV tier on the card: a page spilled through the migrator's
    side stream into the page-locked arena and fetched back is the same
    bits; then a pool of about two chains serves two rounds of prompts on
    four shared prefixes one at a time, with the migration thread and
    with inline migration: both spill and fetch, give the same tokens,
    and leave the ledger and the arena's pins whole."""
    import numpy as np
    from bigdl_tpu_torch.llm.kvtier import KVTier
    from bigdl_tpu_torch.llm.serving import LLMServer
    tier = KVTier(4, PAGE, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    page = torch.randn((2, 2, PAGE, 16), generator=g, device=cuda).to(
        torch.bfloat16)
    key = tuple(range(PAGE))
    slot = tier.arena.reserve(key)
    ready = torch.cuda.Event()
    ready.record()
    assert tier.migrator.submit_spill(key, slot, page, page * 2,
                                      ready).done.wait(60)
    tier.arena.pin(slot)
    job = tier.migrator.submit_fetch([(key, slot)])
    assert job.done.wait(60) and job.ok and tier.arena.pinned() == 0
    assert tier.arena._k.is_pinned() and job.event is not None
    assert torch.equal(job.k_dev[0], page)
    assert torch.equal(job.v_dev[0], page * 2)
    tier.close()

    model = _tiny_card_model(cuda)
    rs = np.random.RandomState(3)
    groups = [rs.randint(0, 256, 2 * PAGE) for _ in range(4)]
    prompts = [np.concatenate([groups[j % 4], rs.randint(0, 256, 2 + j % 3)])
               for j in range(8)]
    outs = []
    for sync in (False, True):
        srv = LLMServer(model, max_batch=2, max_seq_len=64, page_size=PAGE,
                        num_pages=9, kvcache=True, kvtier=True,
                        host_pages=32, kvtier_sync=sync, device=cuda).start()
        try:
            outs.append([srv.submit(p, max_new_tokens=4).get(timeout=300)
                         for p in prompts])
        finally:
            srv.stop()
        st = srv._kv.debug_stats()
        assert srv.errors == [] and st["tier"]["spills"] > 0
        assert st["tier"]["fetches"] > 0 and st["tier"]["fetch_failures"] == 0
        assert st["pages_pinned"] == st["tier"]["pinned"] == 0
        assert st["budget_avail"] == 8
    assert outs[0] == outs[1]


def _tiny_family_card_model(cuda, name, device=None):
    """A small GPT-NeoX (D = 64, rotary over 16 dims), StarCoder (4 query
    heads on one K/V head of D = 128: q4_0 multi-query k/v at N = 128) or
    Bloom (ALiBi) with q4_0 weights drawn on the card from a seed; with
    ``device``, the same weights there."""
    from bigdl_tpu_torch.llm.models import (BloomConfig, BloomForCausalLM,
                                            GptNeoXConfig, GptNeoXForCausalLM,
                                            StarCoderConfig,
                                            StarCoderForCausalLM)
    small = dict(vocab_size=256, num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=128)
    cfg, cls = {
        "neox": (GptNeoXConfig(hidden_size=256, intermediate_size=512,
                               **small), GptNeoXForCausalLM),
        "starcoder": (StarCoderConfig(hidden_size=512, intermediate_size=1024,
                                      **small), StarCoderForCausalLM),
        "bloom": (BloomConfig(hidden_size=256, **small),
                  BloomForCausalLM)}[name]
    model = cls.from_config(cfg, seed=8, load_in_low_bit="sym_int4",
                            max_cache_len=128, device=cuda)
    return model if device is None else cls(cfg, model.params, 128,
                                            device=device)


@pytest.mark.parametrize("name", ["neox", "starcoder"])
def test_family_captured_steps_equal_eager(cuda, name):
    """A family's decode, mixed and verify steps as CUDA graphs, each the
    family's own step as the engine picks it, against the eager step bit
    for bit (the rotary and ``wpe`` positions are device tensors)."""
    model = _tiny_family_card_model(cuda, name)
    _captured_decode_check(model, cuda)
    _captured_mixed_check(model, cuda)
    _captured_spec_check(model, cuda, 8)


@pytest.mark.parametrize("name", ["neox", "starcoder", "bloom"])
def test_family_card_vs_cpu(cuda, name):
    """The same q4_0 weights on the card and the CPU: prefill logits of
    two 24-token rows within 2e-2 of their largest magnitude; then
    ``generate`` on the card with exact launch counts (6 linears a layer
    at the prefill and each step, one stats kernel a layer a step on the
    paged loop; Bloom dense, no attention kernel)."""
    from bigdl_tpu_torch.llm import kernels
    card = _tiny_family_card_model(cuda, name)
    cpu = _tiny_family_card_model(cuda, name, device="cpu")
    ids = torch.randint(0, 256, (2, 24),
                        generator=torch.Generator().manual_seed(0)).numpy()
    lc, _ = cpu(ids)
    lg, _ = card(ids)
    assert ((lg.cpu() - lc).abs().max() / lc.abs().max()).item() < 2e-2
    n, L = 8, card.config.num_hidden_layers
    kernels.reset_launch_counts()
    out = card.generate(ids, max_new_tokens=n)
    counts = kernels.launch_counts()
    assert counts["int4_matmul"] == 6 * L * (1 + n)
    assert counts["paged_attention_decode_stats"] == \
        (0 if name == "bloom" else L * n)
    assert out.shape == (2, 24 + n) and out.max() < 256


def test_families_served_on_card(cuda):
    """GPT-NeoX and StarCoder served on the card through the prefix cache
    with mixed dispatch and through speculation: in-vocab tokens, the
    decode graph and the mode's graphs captured; Bloom refuses."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    rs = torch.Generator().manual_seed(2)
    shared = torch.randint(0, 256, (20,), generator=rs)
    prompts = [torch.cat([shared, torch.randint(0, 256, (k,), generator=rs)])
               .numpy() for k in (3, 30)]
    for name in ("neox", "starcoder"):
        model = _tiny_family_card_model(cuda, name)
        for kw in (dict(kvcache=True, mixed=True, chunk_tokens=PAGE),
                   dict(spec=True, spec_k=4)):
            toks, srv = _serve_tiny(model, prompts, 10, **kw)
            assert srv.errors == [] and srv._decode.capture_seconds > 0
            assert all(len(t) == 10 and max(t) < 256 for t in toks)
            assert srv.mixed_passes > 0 if "mixed" in kw else True
    with pytest.raises(NotImplementedError, match="paged decode"):
        LLMServer(_tiny_family_card_model(cuda, "bloom"), device=cuda)



HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemsetAsync", "cudaMemcpyAsync")


def _observed_passes(model, cuda, on):
    """Five served passes of 4 decoding rows traced with
    ``torch.profiler``, observability and the flight recorder ``on`` or
    off: host launch calls by name and kernels, a pass. No page grant
    falls in the window (positions 20..25, the first a profiler warm-up
    left out of the counts), so a pass is one graph replay, the token
    copy and the drain."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile, schedule

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.observability import flight
    (obs.enable if on else obs.disable)()
    flight.enabled = on
    try:
        srv = LLMServer(model, max_batch=4, max_seq_len=128, page_size=PAGE,
                        device=cuda)
        gen = torch.Generator().manual_seed(3)
        reqs = [srv.submit(torch.randint(0, 256, (17,), generator=gen)
                           .numpy(), 12) for _ in range(4)]
        with torch.inference_mode():
            for _ in range(3):
                srv._admit()
                srv._step()
            assert srv._decode.graph is not None
            # a warm-up pass outside the counts, and no device work in
            # flight across the counted window's edges
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=5,
                                           repeat=1)) as prof:
                for i in range(6):
                    srv._admit()
                    srv._step()
                    if i in (0, 5):
                        torch.cuda.synchronize()
                    prof.step()
            while not all(r.done.is_set() for r in reqs):
                srv._admit()
                srv._step()
        assert srv.errors == []
        srv.stop()
    finally:
        obs.enable()
        flight.enabled = False
    cuda_t = torch.autograd.DeviceType.CUDA
    host = Counter(e.name for e in prof.events()
                   if e.device_type != cuda_t and e.name in HOST_LAUNCH_CALLS)
    kernels = sum(e.device_type == cuda_t        # not the step markers
                  and not e.name.startswith("ProfilerStep")
                  for e in prof.events())
    return {n: c / 5 for n, c in host.items()}, kernels / 5, \
        [r.tokens for r in reqs]


def test_instruments_keep_the_graphed_pass(cuda):
    """The graphed decode pass makes the same host calls (one graph
    launch, one token copy) and runs the same kernels with observability
    on and off, and serves the same tokens."""
    model = _tiny_card_model(cuda)
    on, off = (_observed_passes(model, cuda, x) for x in (True, False))
    assert on == off
    assert on[0] == {"cudaGraphLaunch": 1.0, "cudaMemcpyAsync": 1.0}
    assert on[1] > 0


def test_watchdog_quiet_through_warmed_run(cuda):
    """Every bucket warmed inline before ``start()`` arms the watchdog: a
    served run then never trips it, and the SLO account classifies every
    request."""
    from bigdl_tpu_torch.llm.serving import LLMServer
    model = _tiny_card_model(cuda)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, 256, (n,), generator=gen).numpy()
               for n in (5, 17, 33, 70)]
    srv = LLMServer(model, max_batch=4, max_seq_len=128, page_size=PAGE,
                    watchdog_timeout=1.0, slo=True, device=cuda)
    with torch.inference_mode():
        warm = [srv.submit(p, 3) for p in prompts]
        while not all(r.done.is_set() for r in warm):
            srv._admit()
            srv._step()
        while srv._inflight:
            srv._drain_next()
    srv.start()
    try:
        outs = [r.get(timeout=120) for r in
                [srv.submit(p, 16) for p in prompts * 2]]
        time.sleep(1.5)                   # idle longer than the timeout
    finally:
        srv.stop()
    assert all(len(o) == 16 for o in outs) and outs[:4] == outs[4:]
    assert srv.watchdog_enabled and srv.watchdog_trips == 0
    assert not srv.watchdog_tripped and srv.errors == []
    assert srv._slo.requests == 12


def test_peaks_from_the_device_name(cuda):
    """The roofline's peaks match the card by its name (the H100 SXM:
    989 TFLOP/s dense bf16, 3,350 GB/s); a conf override wins."""
    from bigdl_tpu_torch.observability import utilization
    from bigdl_tpu_torch.utils.conf import conf
    name = torch.cuda.get_device_name(0).lower()
    if "h100" not in name or "pcie" in name or "nvl" in name:
        pytest.skip(f"not an H100 SXM: {name}")
    assert utilization.peaks() == (989e12, 3350.0)
    conf.set("bigdl.device.peak.gbps", "1000")
    try:
        assert utilization.peaks() == (989e12, 1000.0)
    finally:
        conf.unset("bigdl.device.peak.gbps")


def test_capture_records_one_entry(cuda):
    """One captured decode step of the tiny (7B-shaped: Llama, q4_0,
    fused linears) model records one capture entry under its name: its
    capture seconds, pool bytes, launches a replay and costs."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.serving import bind_decode_step, step_costs
    from bigdl_tpu_torch.observability import compile_recorder
    model = _tiny_card_model(cuda)
    cfg, B, cap = model.config, 4, 4
    shape = (cfg.num_hidden_layers, 1 + B * cap, cfg.num_key_value_heads,
             PAGE, cfg.head_dim)
    bufs = [torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
            for _ in range(2)] + [
        (1 + torch.arange(B * cap, device=cuda)).reshape(B, cap).int(),
        torch.tensor([3, 9, 0, 0], dtype=torch.int32, device=cuda),
        torch.zeros((B, cfg.vocab_size), device=cuda),
        torch.tensor([True, True, False, False], device=cuda),
        torch.zeros(B, dtype=torch.int32, device=cuda)]
    costs = step_costs(model.params, cfg, B, torch.bfloat16)
    obs.enable()
    before = {r["fn"]: r["compiles"]
              for r in compile_recorder.compile_stats()}
    step = CapturedStep(bind_decode_step(model.params, cfg, *bufs,
                                         page=PAGE), cuda,
                        name="llm/test_decode", signature=f"B={B}",
                        costs=costs)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    (rec,) = [r for r in compile_recorder.compile_stats()
              if r["fn"] == "llm/test_decode"]
    assert rec["compiles"] - before.get("llm/test_decode", 0) == 1
    entry = rec["history"][-1]
    assert entry["capture_s"] == round(step.capture_seconds, 4) > 0
    assert entry["pool_bytes"] == step.pool_bytes
    assert entry["launches"] == step.launches and \
        entry["launches"]["paged_attention_decode_stats"] == \
        cfg.num_hidden_layers
    assert compile_recorder.latest_costs()["llm/test_decode"] == \
        (costs["flops"], costs["bytes"])
    step.close()


def test_bw_util_after_a_graphed_run(cuda):
    """With the flight recorder on, the drained steps of a graphed served
    run feed ``bigdl_device_bw_util``: in (0, 1.05]."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.observability import flight, utilization
    model = _tiny_card_model(cuda)
    obs.enable()
    utilization.reset()
    flight.enabled = True
    try:
        outs, srv = _serve_tiny(model, [list(range(1, 20)),
                                        list(range(5, 40))], 24)
        bw = obs.REGISTRY.sample_value("bigdl_device_bw_util")
        rows = {r["fn"]: r for r in utilization.roofline_table()}
    finally:
        flight.enabled = False
    assert all(len(o) == 24 for o in outs)
    assert rows["llm/decode_paged"]["calls"] >= 23
    assert bw is not None and 0 < bw <= 1.05


def test_timeseries_plane_keeps_the_graphed_pass(cuda):
    """With the time-series plane on — its sampler reading the registry
    every 10 ms while the passes run — the graphed decode pass makes the
    same host calls and runs the same kernels as with it off."""
    from bigdl_tpu_torch.observability import timeseries
    from bigdl_tpu_torch.utils.conf import conf
    model = _tiny_card_model(cuda)
    off = _observed_passes(model, cuda, True)
    conf.set("bigdl.observability.timeseries.enabled", "true")
    conf.set("bigdl.observability.timeseries.interval", "0.01")
    try:
        st = timeseries.acquire()
        on = _observed_passes(model, cuda, True)
        samples = st.samples_total
    finally:
        timeseries.release()
        conf.unset("bigdl.observability.timeseries.enabled")
        conf.unset("bigdl.observability.timeseries.interval")
        timeseries.reset()
    assert on == off and samples > 0
    assert on[0] == {"cudaGraphLaunch": 1.0, "cudaMemcpyAsync": 1.0}


def test_converted_model_reloads_bit_for_bit(cuda, tmp_path):
    """``save_model`` then ``load_model`` on the card: greedy ids and the
    last step's logits bit for bit those of the source with its q4_0
    scales rounded to bf16 (the on-disk format's rule), and the served
    engine's answers equal on the two models."""
    from bigdl_tpu_torch.llm.convert_model import (as_stored, load_model,
                                                   save_model)
    from bigdl_tpu_torch.llm.models.llama import LlamaForCausalLM
    from bigdl_tpu_torch.llm.serving import LLMServer
    model = _tiny_card_model(cuda)
    save_model(model, str(tmp_path))
    loaded = load_model(str(tmp_path), device=cuda)
    ref = LlamaForCausalLM(model.config, as_stored(model.params),
                           device=cuda)
    ids = torch.randint(0, 256, (2, 21),
                        generator=torch.Generator().manual_seed(8)).numpy()
    got, want = (m.generate(ids, max_new_tokens=24) for m in (loaded, ref))
    assert (got == want).all()
    full = torch.as_tensor(got[:, :-1], device=cuda)
    assert torch.equal(loaded(full)[0][:, -1], ref(full)[0][:, -1])
    outs = []
    for m in (loaded, ref):
        srv = LLMServer(m, max_batch=2, max_seq_len=64, page_size=PAGE,
                        device=cuda).start()
        try:
            outs.append([srv.submit(p, 12).get(timeout=120) for p in ids])
        finally:
            srv.stop()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("qtype", ("sym_int4", "asym_int4", "sym_int5",
                                   "sym_int8", "nf4", "fp4", "fp8", "bf16"))
def test_quantize_torch_on_card_bit_equal_numpy(cuda, qtype):
    """``quantize_torch`` on the card gives the numpy path's bits (a CUDA
    tensor divided by a Python number is multiplied by its reciprocal:
    the scales divide by a 0-d tensor instead), edges included."""
    import numpy as np
    from bigdl_tpu_torch.llm.ggml.quantize import (quantize_numpy,
                                                   quantize_torch)
    w = (np.random.RandomState(3).randn(512, 1024) * 0.05).astype(
        np.float32)
    w[0, :32] = 0.0
    w[1, :3] = [464.0, -480.0, 1e5 if qtype == "fp8" else 3.0]
    with np.errstate(over="ignore"):
        want = quantize_numpy(w, qtype)
    got = quantize_torch(torch.from_numpy(w).to(cuda), qtype)
    for k, v in want.items():
        if k != "qtype":
            g = got[k].cpu()
            if g.dtype in (torch.bfloat16, torch.float8_e4m3fn):
                g = g.view(torch.int16 if g.element_size() == 2
                           else torch.uint8)
            assert np.array_equal(g.numpy().view(v.dtype), v), k


# -- DLlib training ---------------------------------------------------------------

def _cifar_sgd_step(model, x, y, device):
    from bigdl_tpu_torch import nn, optim
    opt = optim.LocalOptimizer(model, (x, y), nn.ClassNLLCriterion(), 4,
                               optim.Trigger.max_iteration(2),
                               device=device)
    opt.set_optim_method(optim.SGD(0.1, momentum=0.9, weight_decay=1e-4))
    return opt.optimize(), opt.state["loss"]


def test_resnet_cifar8_step_card_matches_cpu(cuda, monkeypatch):
    """Two SGD iterations of ``resnet_cifar(8)`` on the card and on the
    CPU from the same weights, f32 with TF32 off: the loss, every
    parameter and the BN running statistics within 1e-4."""
    import numpy as np

    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.utils.tree import tree_leaves
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rs = np.random.RandomState(0)
    x = rs.rand(8, 3, 32, 32).astype(np.float32)
    y = (rs.randint(0, 10, 8) + 1).astype(np.float32)
    host = resnet.resnet_cifar(8, 10, device="cpu")
    card = resnet.resnet_cifar(8, 10, device="cpu")
    card.load_state_dict(host.state_dict())
    (h, hl), (c, cl) = (_cifar_sgd_step(host, x, y, "cpu"),
                        _cifar_sgd_step(card, x, y, cuda))
    assert abs(cl - hl) <= 1e-4 * max(1.0, abs(hl))
    for tree in ("parameters_dict", "states_dict"):
        for a, b in zip(tree_leaves(getattr(c, tree)()),
                        tree_leaves(getattr(h, tree)())):
            torch.testing.assert_close(a.detach().cpu(), b.detach(),
                                       rtol=1e-4, atol=1e-4)


def test_training_entry_points_need_a_gpu_unless_cpu(monkeypatch,
                                                     tmp_path):
    """Without a GPU, ``device=None`` raises on every training entry
    point; ``device="cpu"`` runs. Runs on any machine."""
    import numpy as np

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import lenet, resnet
    m = lenet.build_model(10, device="cpu")
    m.save_module(str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = (np.zeros((4, 28, 28), np.float32), np.ones(4, np.float32))
    for call in (lambda: optim.Optimizer(m, data, nn.ClassNLLCriterion()),
                 lambda: optim.LocalOptimizer(m, data,
                                              nn.ClassNLLCriterion()),
                 lambda: optim.DistriOptimizer(m, data,
                                               nn.ClassNLLCriterion()),
                 lambda: optim.Optimizer(m, data, nn.ClassNLLCriterion(),
                                         distributed=True),
                 lambda: optim.Evaluator(m), lambda: optim.Predictor(m),
                 lambda: lenet.build_model(10),
                 lambda: resnet.resnet_cifar(8),
                 lambda: resnet.resnet_imagenet(18),
                 lambda: nn.Module.load_module(str(tmp_path / "m"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    opt = optim.Optimizer(m, data, nn.ClassNLLCriterion(), batch_size=2,
                          end_trigger=optim.Trigger.max_iteration(1),
                          device="cpu")
    assert opt.optimize() is m and opt.state["iteration_done"] == 1


# -- the DLlib graph, Keras API and zoo: phase 16's card-vs-CPU checks, small

def _step_both(build, x, y, crit, method, cuda, clip=None):
    """One ``LocalOptimizer`` step of ``build()`` on the CPU and on the
    card from one set of weights (dropout from one seeded CPU generator):
    ``(init, cpu params, card params, cpu loss, card loss)``."""
    from bigdl_tpu_torch import optim
    init = {k: v.detach().clone() for k, v in build().state_dict().items()}
    out = []
    for dev in ("cpu", cuda):
        m = build()
        m.load_state_dict(init)
        for mod in m.modules():
            if hasattr(mod, "_draw_generator"):
                mod.generator = torch.Generator().manual_seed(0)
        opt = optim.LocalOptimizer(m, (x, y), crit, len(x),
                                   optim.Trigger.max_iteration(1),
                                   device=dev)
        opt.set_optim_method(method)
        if clip is not None:
            opt.set_gradient_clipping_by_l2_norm(clip)
        out.append((dict(opt.optimize().named_parameters()),
                    opt.state["loss"]))
    (cpu, cpu_l), (card, card_l) = out
    return init, cpu, card, cpu_l, card_l


def _update_dev(init, cpu, card):
    """The card's step beside the CPU's: the update's L2 deviation over
    its L2 norm, and the largest deviation of a parameter tensor over its
    own update's largest entry."""
    dev_sq = upd_sq = per = 0.0
    for k in cpu:
        d = card[k].detach().cpu() - cpu[k].detach()
        u = cpu[k].detach() - init[k]
        dev_sq += float((d ** 2).sum())
        upd_sq += float((u ** 2).sum())
        umax = float(u.abs().max())
        if umax:
            per = max(per, float(d.abs().max()) / umax)
    return (dev_sq / upd_sq) ** 0.5, per


def test_inception_step_card_matches_cpu(cuda, monkeypatch):
    """Inception-v1 at full width, 64 x 64, batch 2, one f32 SGD step
    (TF32 off): the loss within 1e-5 (relative), the update's L2
    deviation within 1e-4 of the update and each parameter tensor within
    1e-2 of its own update's largest entry (an H100 read 6.8e-6 and
    6.3e-4; phase 16 (a) holds the same at 224 x 224)."""
    import numpy as np

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import inception
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rs = np.random.RandomState(0)
    x = rs.rand(2, 3, 64, 64).astype(np.float32)
    y = np.array([5.0, 900.0], np.float32)
    init, cpu, card, cpu_l, card_l = _step_both(
        lambda: inception.inception_v1(1000, device="cpu"), x, y,
        nn.ClassNLLCriterion(), optim.SGD(0.0898, momentum=0.9,
                                          weight_decay=1e-4), cuda)
    assert abs(card_l - cpu_l) <= 1e-5 * abs(cpu_l)
    l2, per = _update_dev(init, cpu, card)
    assert l2 <= 1e-4 and per <= 1e-2, (l2, per)


def test_keras_fit_card_matches_cpu(cuda, monkeypatch):
    """A functional Keras model (two convolution towers merged, pooling,
    dense) fit for 2 steps at ``distributed=False`` on the card and on
    the CPU from one set of weights: weights and ``predict`` within 1e-4
    (phase 16 (b))."""
    import numpy as np

    from bigdl_tpu_torch import keras as K
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def build():
        a = K.Input(shape=(3, 16, 16))
        c1 = K.Convolution2D(4, 3, 3, activation="relu",
                             border_mode="same", subsample=(2, 2))(a)
        c2 = K.Convolution2D(4, 1, 1, subsample=(2, 2))(a)
        h = K.MaxPooling2D((3, 3), (2, 2), "same")(
            K.merge([c1, c2], mode="concat"))
        out = K.Activation("log_softmax")(K.Dense(5)(
            K.GlobalAveragePooling2D()(h)))
        m = K.Model(input=a, output=out)
        m.compile("sgd", "class_nll")
        return m

    rs = np.random.RandomState(1)
    x = rs.rand(16, 3, 16, 16).astype(np.float32)
    y = (rs.randint(0, 5, 16) + 1).astype(np.float32)
    host, card = build(), build()
    card.set_weights(host.get_weights())
    host.fit(x, y, batch_size=8, nb_epoch=1, distributed=False, device="cpu")
    card.fit(x, y, batch_size=8, nb_epoch=1, distributed=False, device=cuda)
    from bigdl_tpu_torch.utils.tree import tree_leaves
    want = tree_leaves(card.module.carry_keys(host.get_weights()))
    got = tree_leaves(card.get_weights())
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card.predict(x, device=cuda),
                               host.predict(x, device="cpu"),
                               rtol=1e-4, atol=1e-4)


def test_ptb_lstm_step_card_matches_cpu(cuda, monkeypatch):
    """The PTB LSTM language model, narrowed (2 x 64, vocabulary 500, 35
    steps, batch 2), one f32 SGD 1.0 step with the norm clipped at 5: the
    loss within 1e-5 (relative), the update's L2 deviation within 1e-5 of
    the update and each parameter tensor within 1e-2 of its own update's
    largest entry (an H100 read 1.4e-6 and 3.1e-4; phase 16 (c) holds the
    same at the medium size)."""
    import numpy as np

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import rnn
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rs = np.random.RandomState(2)
    x = (rs.randint(0, 500, (2, 35)) + 1).astype(np.float32)
    y = (rs.randint(0, 500, (2, 35)) + 1).astype(np.float32)
    init, cpu, card, cpu_l, card_l = _step_both(
        lambda: rnn.build_model(500, 64, 500, "lstm", 2, device="cpu"), x, y,
        nn.TimeDistributedCriterion(nn.ClassNLLCriterion()), optim.SGD(1.0),
        cuda, clip=5.0)
    assert abs(card_l - cpu_l) <= 1e-5 * abs(cpu_l)
    l2, per = _update_dev(init, cpu, card)
    assert l2 <= 1e-5 and per <= 1e-2, (l2, per)


CHRONOS = {
    "TCNForecaster": dict(past_seq_len=24, future_seq_len=6,
                          input_feature_num=8, output_feature_num=8,
                          num_channels=(16, 16, 16), dropout=0.0),
    "Seq2SeqForecaster": dict(past_seq_len=24, future_seq_len=6,
                              input_feature_num=8, output_feature_num=8,
                              lstm_hidden_dim=16, lstm_layer_num=2),
    "LSTMForecaster": dict(past_seq_len=24, future_seq_len=6,
                           input_feature_num=8, output_feature_num=8,
                           hidden_dim=16, layer_num=2, dropout=0.0),
    "NBeatsForecaster": dict(past_seq_len=24, future_seq_len=6,
                             nbeats_units=32),
    "AutoformerForecaster": dict(past_seq_len=24, future_seq_len=6,
                                 input_feature_num=8, output_feature_num=8,
                                 d_model=16),
}


@pytest.mark.parametrize("name", list(CHRONOS))
def test_forecaster_card_matches_cpu(cuda, monkeypatch, name):
    """Each Chronos forecaster's forward, then one Adam step of ``fit``
    (batch 16, dropout 0, f32 with TF32 off), on the card and on the CPU
    from the same weights: the forward within 1e-5, the loss within 1e-5
    (relative) and every weight within 1e-5 of the largest. The
    Autoformer's ``embed_b`` and ``ff2_b`` have a zero exact gradient
    (the series decomposition after them takes a constant out), so Adam
    steps them by its normalised rounding noise: held to one step's lr."""
    import numpy as np

    from bigdl_tpu_torch.chronos import forecaster as F
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    kw = CHRONOS[name]
    c_in = kw.get("input_feature_num", 1)
    rs = np.random.RandomState(0)
    x = rs.randn(16, 24, c_in).astype(np.float32)
    y = rs.randn(16, 6, kw.get("output_feature_num", 1)).astype(np.float32)
    host = getattr(F, name)(**kw, device="cpu")
    card = getattr(F, name)(**kw, device=cuda)
    card.model.load_parameters_dict(host.model.parameters_dict())
    torch.testing.assert_close(torch.from_numpy(card.predict(x)),
                               torch.from_numpy(host.predict(x)),
                               rtol=0, atol=1e-5)
    hl, cl = host.fit((x, y), batch_size=16), card.fit((x, y), batch_size=16)
    assert abs(cl - hl) <= 1e-5 * max(1.0, abs(hl))
    ws = dict(host.model.named_parameters())
    top = max(float(w.abs().max()) for w in ws.values())
    free = ("embed_b", "ff2_b") if name == "AutoformerForecaster" else ()
    for k, a in card.model.named_parameters():
        torch.testing.assert_close(
            a.detach().cpu(), ws[k].detach(), rtol=0,
            atol=host.lr if k in free else 1e-5 * top)
