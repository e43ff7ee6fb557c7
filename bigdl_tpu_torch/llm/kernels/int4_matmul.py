"""Block-dequant matmuls — the port of ``bigdl_tpu/llm/kernels/int4_matmul.py``
(``int4_matmul``, ``asym_int4_matmul``, ``int8_matmul`` and their layout
helpers).

The public layout is the JAX package's k-major "TPU layout": packed
weights ``q_t`` (K/2, N) uint8 for the 4-bit formats (low nibble = row
2i, high = row 2i+1) or (K, N) int8 for q8_0, and per-32-group scales
(and q4_1 zeros) ``(K/32, N)`` f32. It suits the CUDA kernels too:
neighbouring threads take neighbouring output columns, so the weight
stream is read coalesced with no transpose.

Each format has two CUDA kernels, and :func:`matmul_route` picks one
from the shape alone before the launch: the tensor-core GEMM for
``M >= TC_MIN_M`` rows when ``N % 16 == 0`` (``csrc/int4_matmul_tc.cu``
for q4_0, ``csrc/lowbit_matmul_tc.cu`` for q4_1 and q8_0, one main loop
in ``csrc/tc_gemm.cuh``), the split-K tensor-core GEMV otherwise
(``csrc/lowbit_gemv.cu``, all three formats) — decode (M <= 8), BERT's
pooler and N = 2 classifier, N = 770. The GEMV is bound by its weight
stream: TMA brings each warp 32-row groups of its 128 columns, three in
flight, whose k-major bytes are the lanes' A fragments as they stand,
and K is split over :func:`gemv_slices` warps (a thread-block cluster,
reduced in slice order through distributed shared memory) so that every
decode shape fills the card.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
takes its plain PyTorch version (``*_reference``: dequantize to f32, f32
matmul, cast) only for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.llm.ggml.quantize import (KERNEL_QTYPES, QK, quantize,
                                               quantize_torch)
from bigdl_tpu_torch.llm.kernels import _build, _counts

# the least M that takes the tensor-core kernels. Chosen from H100
# timings of both routes at M = 1..64 on the decode shapes (PERF.md): the
# GEMV's time steps with ceil(M / 8), and a 7B layer's four linears are
# faster on it through M = 32, on the tensor cores from M = 40
TC_MIN_M = 33
# the SMs of an H100 SXM: the tensor-core kernel's block shape is chosen
# so that a small product still makes one full wave (tc_block_shape)
TC_SMS = 132
# the GEMV: output columns a warp, warps (K slices) a block, at most 8
# blocks a cluster along K, and the warps a product should reach (about
# six an SM: more slices cost more than they hide, timed on the H100,
# PERF.md)
GEMV_COLS = 128
GEMV_WARPS = 4
GEMV_MAX_SLICES = 8 * GEMV_WARPS
GEMV_TARGET_WARPS = 768


def to_tpu_layout(qdict: Dict) -> Dict:
    """ggml row-major ``quantize()`` dict → k-major kernel layout:
    q (N, K/2) or (N, K) → (K/2, N) or (K, N); scale (and zero) (N, G)
    fp16 → (G, N) f32. Works on numpy arrays and on tensors (kept on
    their device). The formats without a kernel (``sym_int5``, ``nf4``,
    ``fp4``, ``fp8``, ``bf16``) pass through unchanged, as in the JAX
    package: they keep the row-major ggml layout."""
    qtype = qdict.get("qtype", "sym_int4")
    if qtype not in KERNEL_QTYPES:
        return dict(qdict)
    out = {"qtype": qtype}
    for key in ("q", "scale", "zero"):
        if key not in qdict:
            continue
        a = qdict[key]
        if isinstance(a, torch.Tensor):
            a = a if key == "q" else a.to(torch.float32)
            out[key] = a.t().contiguous()
        else:
            a = np.asarray(a) if key == "q" else np.asarray(a, np.float32)
            out[key] = np.ascontiguousarray(a.T)
    return out


def quantize_tpu(w, qtype: str = "sym_int4") -> Dict:
    """quantize() + to_tpu_layout() in one step — numpy in, numpy out;
    a tensor is quantized on its own device (:func:`quantize_torch`)."""
    if isinstance(w, torch.Tensor):
        return to_tpu_layout(quantize_torch(w, qtype))
    return to_tpu_layout(quantize(w, qtype))


# -- plain versions ----------------------------------------------------------

def _unpack_k(q_t: torch.Tensor) -> torch.Tensor:
    """(K/2, N) packed bytes → (K, N) int32 nibbles, row 2i = low."""
    half, n = q_t.shape
    lo = (q_t & 0xF).to(torch.int32)
    hi = (q_t >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=1).reshape(half * 2, n)


def _per_group(q: torch.Tensor) -> torch.Tensor:
    """(K, N) values → (G, 32, N) f32, to meet (G, 1, N) scales."""
    k, n = q.shape
    return q.to(torch.float32).reshape(k // QK, QK, n)


def dequant_q4(q_t: torch.Tensor, scale_t: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """k-major q4_0 dequant (the port of ``llama._dequant_q4``): returns
    w (K, N) so that y = x @ w, with w = scale * (q - 8)."""
    q = _unpack_k(q_t) - 8
    w = _per_group(q) * scale_t.to(torch.float32)[:, None, :]
    return w.reshape(q.shape).to(dtype)


def dequant_q4_1(q_t: torch.Tensor, scale_t: torch.Tensor,
                 zero_t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """k-major q4_1 dequant: w (K, N) = scale * q + zero, rounded after
    the product and after the sum (``LowBitLinear._dequant``)."""
    q = _unpack_k(q_t)
    w = (_per_group(q) * scale_t.to(torch.float32)[:, None, :]
         + zero_t.to(torch.float32)[:, None, :])
    return w.reshape(q.shape).to(dtype)


def dequant_q8_0(q_t: torch.Tensor, scale_t: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """k-major q8_0 dequant: w (K, N) = scale * q, q int8."""
    w = _per_group(q_t) * scale_t.to(torch.float32)[:, None, :]
    return w.reshape(q_t.shape).to(dtype)


def _plain(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    y = x.to(torch.float32) @ w
    return y.to(out_dtype if out_dtype is not None else x.dtype)


def int4_matmul_reference(x: torch.Tensor, q_t: torch.Tensor,
                          scale_t: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain version: :func:`dequant_q4` in f32 followed by an f32
    matmul, cast to ``out_dtype`` (default: x's dtype). The kernel reads
    x in bf16 (the TPU kernel's cast point); given bf16 x the two see the
    same inputs and differ only in f32 summation order."""
    return _plain(x, dequant_q4(q_t, scale_t), out_dtype)


def _slice_bounds(groups: int, slices: int):
    """The groups of each K slice of the GEMV: slice i takes
    ``[i * G // S, (i + 1) * G // S)`` (some empty when G < S)."""
    return [(i * groups // slices, (i + 1) * groups // slices)
            for i in range(slices)]


def _grouped(x: torch.Tensor, q: torch.Tensor, scale_t: torch.Tensor,
             zero_t: Optional[torch.Tensor],
             out_dtype: Optional[torch.dtype], slices: int = 1
             ) -> torch.Tensor:
    """The CUDA kernels' algebra on (K, N) integer weights ``q``: per
    32-row group g the f32 partial ``P_g = x_g @ q_g`` of exact products
    (and the row sums ``X_g`` of x_g), then ``acc += s_g * P_g`` (then
    ``acc += z_g * X_g``) in group order. With ``slices`` > 1 the groups
    go in contiguous K slices (:func:`_slice_bounds`), each with its own
    accumulator from 0, and the slices' sums are added in slice order:
    the GEMV's order (``csrc/lowbit_gemv.cu``, :func:`gemv_slices`)."""
    m, k = x.shape
    xg = x.to(torch.float32).reshape(m, k // QK, QK).transpose(0, 1)
    part = torch.bmm(xg, _per_group(q))                      # (G, M, N)
    xsum = xg.sum(-1)[..., None]                             # (G, M, 1)
    s = scale_t.to(torch.float32)
    z = None if zero_t is None else zero_t.to(torch.float32)
    out = torch.zeros((m, q.shape[1]), dtype=torch.float32, device=x.device)
    for lo, hi in _slice_bounds(k // QK, slices):
        acc = torch.zeros_like(out)
        for i in range(lo, hi):
            acc = acc + s[i] * part[i]
            if z is not None:
                acc = acc + z[i] * xsum[i]
        out = out + acc
    return out.to(out_dtype if out_dtype is not None else x.dtype)


def int4_matmul_grouped(x: torch.Tensor, q_t: torch.Tensor,
                        scale_t: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None,
                        slices: int = 1) -> torch.Tensor:
    """The CUDA kernels' q4_0 algebra in plain PyTorch: per 32-row group
    g the f32 partial ``P_g = x_g @ (q_g - 8)`` of exact products, then
    ``acc += s_g * P_g`` in group order, cast to ``out_dtype`` (default:
    x's dtype). Equals :func:`int4_matmul_reference` up to f32 summation
    order; the tests hold it to the JAX package. ``slices``: the GEMV's
    split over K (:func:`_grouped`)."""
    return _grouped(x, _unpack_k(q_t) - 8, scale_t, None, out_dtype,
                    slices)


def asym_int4_matmul_grouped(x: torch.Tensor, q_t: torch.Tensor,
                             scale_t: torch.Tensor, zero_t: torch.Tensor,
                             out_dtype: Optional[torch.dtype] = None,
                             slices: int = 1) -> torch.Tensor:
    """The CUDA kernels' q4_1 algebra: per group the exact f32
    partial ``x_g @ q_g`` (q in 0..15) and the row sums ``X_g``, then
    ``acc += s_g * P_g + z_g * X_g`` in group order (the TPU kernel's
    separate zero-point dot). Tests only; the wrapper's plain version is
    :func:`asym_int4_matmul_reference`."""
    return _grouped(x, _unpack_k(q_t), scale_t, zero_t, out_dtype, slices)


def int8_matmul_grouped(x: torch.Tensor, q_t: torch.Tensor,
                        scale_t: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None,
                        slices: int = 1) -> torch.Tensor:
    """The CUDA kernels' q8_0 algebra: per group the exact f32
    partial ``x_g @ q_g`` (q int8), then ``acc += s_g * P_g`` in group
    order; a per-channel (stride-0) scale rescales every group alike.
    Tests only; the wrapper's plain version is
    :func:`int8_matmul_reference`."""
    return _grouped(x, q_t, scale_t, None, out_dtype, slices)


def asym_int4_matmul_reference(x: torch.Tensor, q_t: torch.Tensor,
                               scale_t: torch.Tensor, zero_t: torch.Tensor,
                               out_dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """Plain version of :func:`asym_int4_matmul`: :func:`dequant_q4_1`
    in f32, f32 matmul, cast to ``out_dtype`` (default: x's dtype)."""
    return _plain(x, dequant_q4_1(q_t, scale_t, zero_t), out_dtype)


def int8_matmul_reference(x: torch.Tensor, q_t: torch.Tensor,
                          scale_t: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain version of :func:`int8_matmul`: :func:`dequant_q8_0` in
    f32, f32 matmul, cast to ``out_dtype`` (default: x's dtype)."""
    return _plain(x, dequant_q8_0(q_t, scale_t), out_dtype)


# -- kernel wrappers ---------------------------------------------------------

def _check_shapes(what: str, x: torch.Tensor, q_t: torch.Tensor,
                  rows_per_k: int, groups: Sequence[torch.Tensor]):
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (M, K), got {tuple(x.shape)}")
    k = x.shape[1]
    if q_t.dim() != 2 or q_t.shape[0] * rows_per_k != k or k % QK:
        raise ValueError(
            f"{what}: q_t {tuple(q_t.shape)} is not the (K/{rows_per_k}, N) "
            f"layout for K={k} (K must be a multiple of {QK}); convert "
            "ggml (N, ...) dicts with to_tpu_layout() first")
    for t in groups:
        if tuple(t.shape) != (k // QK, q_t.shape[1]):
            raise ValueError(f"{what}: scale_t/zero_t {tuple(t.shape)} != "
                             f"{(k // QK, q_t.shape[1])}")


def _cuda_inputs(what: str, x: torch.Tensor, q_t: torch.Tensor,
                 q_dtype: torch.dtype, groups: Sequence[torch.Tensor],
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The checks every CUDA entry makes; returns x as contiguous bf16
    (the TPU kernels' cast point)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if any(t.device != x.device for t in (q_t, *groups)):
        raise ValueError(f"{what}: x, q_t and the scales must be on one "
                         "device")
    if q_t.dtype != q_dtype or any(t.dtype != torch.float32 for t in groups):
        raise ValueError(f"{what}: q_t must be {q_dtype} and scales "
                         f"float32, got {q_t.dtype}, "
                         f"{[t.dtype for t in groups]}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: out_dtype {out_dtype} not bf16/f32")
    if not q_t.is_contiguous():
        raise ValueError(f"{what}: q_t must be contiguous")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned")
    return xb


def _group_stride(what: str, t: torch.Tensor) -> int:
    """Row stride of a (K/32, N) scale/zero tensor: N when it is
    contiguous, 0 when one row is broadcast to every group (``expand``,
    nn.quantized's per-channel scale) — the kernel reads either."""
    g, n = t.shape
    if n > 1 and t.stride(1) != 1:
        raise ValueError(f"{what}: scales need unit column stride")
    if g == 1 or t.stride(0) == n:
        return n
    if t.stride(0) == 0:
        return 0
    raise ValueError(f"{what}: scale row stride {t.stride(0)} is neither "
                     f"N={n} nor 0")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def matmul_route(m: int, n: int) -> str:
    """Which CUDA kernel a dequant-matmul wrapper launches for an (M, K)
    x (K, N) product, for all three formats: ``"tc"`` (the tensor-core
    GEMM, ``csrc/int4_matmul_tc.cu`` / ``csrc/lowbit_matmul_tc.cu``) when
    ``m >= TC_MIN_M`` and ``n % 16 == 0`` (16-byte rows of q for its TMA
    loads), else ``"gemv"`` (``csrc/lowbit_gemv.cu``). Both keep the
    exact f32 products of the integer weights and scales; the order of
    an output's sum depends on K, N and the route only, never on the
    other rows."""
    return "tc" if m >= TC_MIN_M and n % 16 == 0 else "gemv"


def gemv_slices(k: int, n: int) -> int:
    """The GEMV's number of K slices (one warp each, ``GEMV_WARPS`` to a
    block, a cluster of ``slices / GEMV_WARPS`` blocks) for a (K, N)
    weight, whatever M: the least power of two from ``GEMV_WARPS`` that
    makes ``GEMV_TARGET_WARPS`` warps over the ``GEMV_COLS``-column
    tiles, at most ``GEMV_MAX_SLICES``, and no more than leaves each
    slice two 32-row groups. Chosen from H100 timings (PERF.md)."""
    tiles, groups = -(-n // GEMV_COLS), k // QK
    s = GEMV_WARPS
    while (s < GEMV_MAX_SLICES and tiles * s < GEMV_TARGET_WARPS
           and 4 * s <= groups):
        s *= 2
    return s


def tc_block_shape(m: int, n: int,
                   zero_point: bool = False) -> Tuple[int, int]:
    """The output tile (rows, columns) of one block of the tensor-core
    kernels, from the shape and the format: 64 x 64 while those blocks
    make at most one wave at two a SM (``<= 2 * TC_SMS``), else 64 x 128
    when M <= 64 (a 128-row block would be half empty), else 128 x 128 —
    or 64 x 64 for a format with a ``zero_point`` (q4_1), whose 128 x 128
    instance runs at 246 registers with twice the rescale work. Chosen
    from H100 timings of all three (PERF.md). Every row's sum runs in
    the same order whatever the tile."""
    if -(-m // 64) * -(-n // 64) <= 2 * TC_SMS:
        return 64, 64
    if m <= 64:
        return 64, 128
    return (64, 64) if zero_point else (128, 128)


# wrapper name -> {route: library}
_LIBS = {"int4_matmul": {"gemv": "lowbit_gemv", "tc": "int4_matmul_tc"},
         "asym_int4_matmul": {"gemv": "lowbit_gemv",
                              "tc": "lowbit_matmul_tc"},
         "int8_matmul": {"gemv": "lowbit_gemv", "tc": "lowbit_matmul_tc"}}


def _launch(wrapper, xb: torch.Tensor, planes: Sequence[torch.Tensor],
            out: torch.Tensor, route: str, lds: Optional[int] = None,
            tile: Optional[Tuple[int, int]] = None,
            slices: Optional[int] = None) -> int:
    """Launch one of ``wrapper``'s kernels on checked CUDA tensors
    (``planes``: q_t, scale_t[, zero_t]; ``lds`` the planes' row stride,
    None for q4_0, whose entries take contiguous scales); counts the
    launch (``wrapper.launches``, and ``wrapper.tc_launches`` or
    ``wrapper.gemv_launches`` by route) and returns the C entry's error
    code. ``tile`` overrides :func:`tc_block_shape` and ``slices``
    :func:`gemv_slices` (timing and tests only)."""
    name = wrapper.__name__
    (m, k), n = xb.shape, planes[0].shape[1]
    ints = [m, k, n] + ([] if lds is None else [lds])
    if route == "tc":
        ints.extend(tile or tc_block_shape(m, n, name == "asym_int4_matmul"))
    else:
        ints.append(slices or gemv_slices(k, n))
    fn = _build.bind(
        _LIBS[name][route], f"{name}_{route}_"
        f"{'bf16' if out.dtype == torch.bfloat16 else 'f32'}out",
        [_build.P] * (len(planes) + 2) + [_build.I] * len(ints) + [_build.P])
    rc = fn(xb.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(),
            *ints, _stream(xb))
    _counts.launched(wrapper, "tc_launches" if route == "tc"
                     else "gemv_launches")
    return rc


def _run(wrapper, x: torch.Tensor, planes: Sequence[torch.Tensor],
         q_dtype: torch.dtype, out_dtype: torch.dtype,
         lds: Optional[int]) -> torch.Tensor:
    """Check the CUDA inputs, route, launch, check the error code. q4_0
    (``lds`` None) takes contiguous 16-byte aligned planes on both
    routes; q4_1 and q8_0 need the alignment (TMA's) on the tensor-core
    route only (the GEMV reads unaligned planes byte by byte)."""
    name = wrapper.__name__
    xb = _cuda_inputs(name, x, planes[0], q_dtype, planes[1:], out_dtype)
    if lds is None and not planes[1].is_contiguous():
        raise ValueError(f"{name}: scale_t must be contiguous")
    (m, _), n = x.shape, planes[0].shape[1]
    route = matmul_route(m, n)
    if ((lds is None or route == "tc")
            and any(t.data_ptr() % 16 for t in planes)):
        raise ValueError(f"{name}: q_t and the scales must be 16-byte "
                         "aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    _build.check(_launch(wrapper, xb, planes, out, route, lds), name)
    return out


def int4_matmul(x: torch.Tensor, q_t: torch.Tensor, scale_t: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant_q4_0(q, scale) in the k-major layout.

    x (M, K); q_t (K/2, N) uint8; scale_t (K/32, N) f32; returns (M, N)
    in ``out_dtype`` (bf16 or f32 on the card). Any M and N. A CUDA x
    launches the CUDA kernel :func:`matmul_route` names (x cast to bf16
    first); a CPU x takes the plain version."""
    _check_shapes("int4_matmul", x, q_t, 2, (scale_t,))
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q_t, scale_t, out_dtype)
    return _run(int4_matmul, x, (q_t, scale_t), torch.uint8, out_dtype,
                None)


def asym_int4_matmul(x: torch.Tensor, q_t: torch.Tensor,
                     scale_t: torch.Tensor, zero_t: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """y = x @ dequant_q4_1(q, scale, zero) in the k-major layout.

    x (M, K); q_t (K/2, N) uint8; scale_t, zero_t (K/32, N) f32; returns
    (M, N) in ``out_dtype``. Any M and N. A CUDA x launches the CUDA
    kernel :func:`matmul_route` names (x cast to bf16 first); a CPU x
    takes the plain version."""
    _check_shapes("asym_int4_matmul", x, q_t, 2, (scale_t, zero_t))
    if x.device.type == "cpu":
        return asym_int4_matmul_reference(x, q_t, scale_t, zero_t,
                                          out_dtype)
    lds = _group_stride("asym_int4_matmul", scale_t)
    if _group_stride("asym_int4_matmul", zero_t) != lds:
        raise ValueError("asym_int4_matmul: scale_t and zero_t need one "
                         "row stride")
    return _run(asym_int4_matmul, x, (q_t, scale_t, zero_t), torch.uint8,
                out_dtype, lds)


def int8_matmul(x: torch.Tensor, q_t: torch.Tensor, scale_t: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant_q8_0(q, scale) in the k-major layout — the
    BigQuant INT8 gemm equivalent.

    x (M, K); q_t (K, N) int8; scale_t (K/32, N) f32, contiguous or one
    row expanded over the groups (a per-channel scale); returns (M, N)
    in ``out_dtype``. Any M and N. A CUDA x launches the CUDA kernel
    :func:`matmul_route` names (x cast to bf16 first); a CPU x takes the
    plain version."""
    _check_shapes("int8_matmul", x, q_t, 1, (scale_t,))
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q_t, scale_t, out_dtype)
    lds = _group_stride("int8_matmul", scale_t)
    return _run(int8_matmul, x, (q_t, scale_t), torch.int8, out_dtype, lds)


for _w in (int4_matmul, asym_int4_matmul, int8_matmul):
    _w.launches = 0
    _w.tc_launches = 0
    _w.gemv_launches = 0
