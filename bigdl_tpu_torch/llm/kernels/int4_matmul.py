"""Block-dequant matmuls — the port of ``bigdl_tpu/llm/kernels/int4_matmul.py``
(``int4_matmul``, ``asym_int4_matmul``, ``int8_matmul`` and their layout
helpers).

The public layout is the JAX package's k-major "TPU layout": packed
weights ``q_t`` (K/2, N) uint8 for the 4-bit formats (low nibble = row
2i, high = row 2i+1) or (K, N) int8 for q8_0, and per-32-group scales
(and q4_1 zeros) ``(K/32, N)`` f32. It suits the CUDA kernels too:
neighbouring threads take neighbouring output columns, so the weight
stream is read coalesced with no transpose (``csrc/int4_matmul.cu`` and
``csrc/int4_matmul_tc.cu`` for q4_0, ``csrc/lowbit_matmul.cu`` for q4_1
and q8_0).

q4_0 has two CUDA kernels, and :func:`int4_route` picks one from the
shape alone before the launch: the tensor-core GEMM
(``int4_matmul_tc.cu``) for ``M >= TC_MIN_M`` rows when ``N % 16 == 0``,
the CUDA-core kernel (``int4_matmul.cu``) otherwise — decode (M <= 8),
BERT's N = 2 classifier and N = 770.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
takes its plain PyTorch version (``*_reference``: dequantize to f32, f32
matmul, cast) only for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.llm.ggml.quantize import (QK, _check_qtype, quantize,
                                               quantize_torch)
from bigdl_tpu_torch.llm.kernels import _build

# the least M that takes the tensor-core q4_0 kernel. Chosen from H100
# timings of both kernels at the served prefill buckets 16..512 (PERF.md)
TC_MIN_M = 16
# the SMs of an H100 SXM: the tensor-core kernel's block shape is chosen
# so that a small product still makes one full wave (tc_block_shape)
TC_SMS = 132


def to_tpu_layout(qdict: Dict) -> Dict:
    """ggml row-major ``quantize()`` dict → k-major kernel layout:
    q (N, K/2) or (N, K) → (K/2, N) or (K, N); scale (and zero) (N, G)
    fp16 → (G, N) f32. Works on numpy arrays and on tensors (kept on
    their device)."""
    qtype = qdict.get("qtype", "sym_int4")
    _check_qtype(qtype)
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


def int4_matmul_grouped(x: torch.Tensor, q_t: torch.Tensor,
                        scale_t: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The CUDA kernels' algebra in plain PyTorch: per 32-row group g the
    f32 partial ``P_g = x_g @ (q_g - 8)`` of exact products, then
    ``acc += s_g * P_g`` in group order, cast to ``out_dtype`` (default:
    x's dtype). Equals :func:`int4_matmul_reference` up to f32 summation
    order; the tests hold it to the JAX package."""
    m, k = x.shape
    g = k // QK
    xg = x.to(torch.float32).reshape(m, g, QK).transpose(0, 1)
    part = torch.bmm(xg, _per_group(_unpack_k(q_t) - 8))     # (G, M, N)
    acc = torch.zeros((m, q_t.shape[1]), dtype=torch.float32,
                      device=x.device)
    s = scale_t.to(torch.float32)
    for i in range(g):
        acc = acc + s[i] * part[i]
    return acc.to(out_dtype if out_dtype is not None else x.dtype)


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


def int4_route(m: int, n: int) -> str:
    """Which CUDA kernel :func:`int4_matmul` launches for an (M, K) x
    (K, N) product: ``"tc"`` (tensor cores, ``csrc/int4_matmul_tc.cu``)
    when ``m >= TC_MIN_M`` and ``n % 16 == 0`` (16-byte rows of q for
    its TMA loads), else ``"cuda_core"`` (``csrc/int4_matmul.cu``).
    Both keep the exact f32 product ``s·(q-8)``; the order of an output's
    sum depends on K and the route only, never on the other rows."""
    return "tc" if m >= TC_MIN_M and n % 16 == 0 else "cuda_core"


def tc_block_shape(m: int, n: int) -> Tuple[int, int]:
    """The output tile (rows, columns) of one block of the tensor-core
    kernel, from the shape alone: 64 x 64 while those blocks make at
    most one wave at two a SM (``<= 2 * TC_SMS``), else 128 x 128, or
    64 x 128 when M <= 64 (a 128-row block would be half empty). Chosen
    from H100 timings of all three (PERF.md). Every row's sum runs in
    the same order whatever the tile."""
    if -(-m // 64) * -(-n // 64) <= 2 * TC_SMS:
        return 64, 64
    return (128, 128) if m > 64 else (64, 128)


def _int4_launch(xb: torch.Tensor, q_t: torch.Tensor, scale_t: torch.Tensor,
                 out: torch.Tensor, route: str,
                 tile: Optional[Tuple[int, int]] = None) -> int:
    """Launch one q4_0 kernel on checked CUDA tensors; counts the launch
    (``int4_matmul.launches``, and ``int4_matmul.tc_launches`` for the
    tensor-core route) and returns the C entry's error code. ``tile``
    overrides :func:`tc_block_shape` (timing only)."""
    (m, k), n = xb.shape, q_t.shape[1]
    lib = "int4_matmul_tc" if route == "tc" else "int4_matmul"
    ints = [m, k, n]
    if route == "tc":
        ints.extend(tile or tc_block_shape(m, n))
    fn = _build.bind(
        lib, f"{lib}_{'bf16' if out.dtype == torch.bfloat16 else 'f32'}out",
        [_build.P] * 4 + [_build.I] * len(ints) + [_build.P])
    rc = fn(xb.data_ptr(), q_t.data_ptr(), scale_t.data_ptr(),
            out.data_ptr(), *ints, _stream(xb))
    int4_matmul.launches += 1
    if route == "tc":
        int4_matmul.tc_launches += 1
    return rc


def int4_matmul(x: torch.Tensor, q_t: torch.Tensor, scale_t: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant_q4_0(q, scale) in the k-major layout.

    x (M, K); q_t (K/2, N) uint8; scale_t (K/32, N) f32; returns (M, N)
    in ``out_dtype`` (bf16 or f32 on the card). Any M and N. A CUDA x
    launches the CUDA kernel :func:`int4_route` names (x cast to bf16
    first); a CPU x takes the plain version."""
    _check_shapes("int4_matmul", x, q_t, 2, (scale_t,))
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q_t, scale_t, out_dtype)
    xb = _cuda_inputs("int4_matmul", x, q_t, torch.uint8, (scale_t,),
                      out_dtype)
    if not scale_t.is_contiguous():
        raise ValueError("int4_matmul: scale_t must be contiguous")
    for t in (q_t, scale_t):
        if t.data_ptr() % 16:
            raise ValueError("int4_matmul: tensors must be 16-byte aligned")
    (m, k), n = x.shape, q_t.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    _build.check(_int4_launch(xb, q_t, scale_t, out, int4_route(m, n)),
                 "int4_matmul")
    return out


def asym_int4_matmul(x: torch.Tensor, q_t: torch.Tensor,
                     scale_t: torch.Tensor, zero_t: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """y = x @ dequant_q4_1(q, scale, zero) in the k-major layout.

    x (M, K); q_t (K/2, N) uint8; scale_t, zero_t (K/32, N) f32; returns
    (M, N) in ``out_dtype``. Any M and N. A CUDA x launches the CUDA
    kernel (x cast to bf16 first); a CPU x takes the plain version."""
    _check_shapes("asym_int4_matmul", x, q_t, 2, (scale_t, zero_t))
    if x.device.type == "cpu":
        return asym_int4_matmul_reference(x, q_t, scale_t, zero_t,
                                          out_dtype)
    xb = _cuda_inputs("asym_int4_matmul", x, q_t, torch.uint8,
                      (scale_t, zero_t), out_dtype)
    lds = _group_stride("asym_int4_matmul", scale_t)
    if _group_stride("asym_int4_matmul", zero_t) != lds:
        raise ValueError("asym_int4_matmul: scale_t and zero_t need one "
                         "row stride")
    (m, k), n = x.shape, q_t.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.bind(
        "lowbit_matmul", "asym_int4_matmul_bf16out"
        if out_dtype == torch.bfloat16 else "asym_int4_matmul_f32out",
        [_build.P] * 5 + [_build.I] * 4 + [_build.P])
    rc = fn(xb.data_ptr(), q_t.data_ptr(), scale_t.data_ptr(),
            zero_t.data_ptr(), out.data_ptr(), m, k, n, lds, _stream(x))
    asym_int4_matmul.launches += 1
    _build.check(rc, "asym_int4_matmul")
    return out


def int8_matmul(x: torch.Tensor, q_t: torch.Tensor, scale_t: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant_q8_0(q, scale) in the k-major layout — the
    BigQuant INT8 gemm equivalent.

    x (M, K); q_t (K, N) int8; scale_t (K/32, N) f32, contiguous or one
    row expanded over the groups (a per-channel scale); returns (M, N)
    in ``out_dtype``. Any M and N. A CUDA x launches the CUDA kernel (x
    cast to bf16 first); a CPU x takes the plain version."""
    _check_shapes("int8_matmul", x, q_t, 1, (scale_t,))
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q_t, scale_t, out_dtype)
    xb = _cuda_inputs("int8_matmul", x, q_t, torch.int8, (scale_t,),
                      out_dtype)
    lds = _group_stride("int8_matmul", scale_t)
    (m, k), n = x.shape, q_t.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.bind(
        "lowbit_matmul", "int8_matmul_bf16out"
        if out_dtype == torch.bfloat16 else "int8_matmul_f32out",
        [_build.P] * 4 + [_build.I] * 4 + [_build.P])
    rc = fn(xb.data_ptr(), q_t.data_ptr(), scale_t.data_ptr(),
            out.data_ptr(), m, k, n, lds, _stream(x))
    int8_matmul.launches += 1
    _build.check(rc, "int8_matmul")
    return out


int4_matmul.launches = 0
int4_matmul.tc_launches = 0
asym_int4_matmul.launches = 0
int8_matmul.launches = 0
