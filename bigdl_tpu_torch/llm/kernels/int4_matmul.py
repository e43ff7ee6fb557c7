"""q4_0 dequant-matmul — the port of ``bigdl_tpu/llm/kernels/int4_matmul.py``
(``int4_matmul`` and its layout helpers).

The public layout is the JAX package's k-major "TPU layout": packed
weights ``q_t`` (K/2, N) uint8 (low nibble = row 2i, high = row 2i+1)
and scales ``scale_t`` (K/32, N) f32. It suits the CUDA kernel too:
neighbouring threads take neighbouring output columns, so the weight
stream is read coalesced with no transpose
(``bigdl_tpu_torch/csrc/int4_matmul.cu``).

:func:`int4_matmul` launches the CUDA kernel for CUDA tensors (or
raises) and takes :func:`int4_matmul_reference`, the plain PyTorch
version, only for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.llm.ggml.quantize import (QK, _check_qtype, quantize,
                                               quantize_torch)
from bigdl_tpu_torch.llm.kernels import _build


def to_tpu_layout(qdict: Dict) -> Dict:
    """ggml row-major ``quantize()`` dict → k-major kernel layout:
    q (N, K/2) → q_t (K/2, N); scale (N, G) fp16 → scale_t (G, N) f32.
    Works on numpy arrays and on tensors (kept on their device)."""
    if qdict.get("qtype", "sym_int4") != "sym_int4":
        raise NotImplementedError("only sym_int4 has a kernel layout in "
                                  "the port (ROADMAP Queue 2 items 4-5)")
    q, s = qdict["q"], qdict["scale"]
    if isinstance(q, torch.Tensor):
        return {"qtype": "sym_int4", "q": q.t().contiguous(),
                "scale": s.to(torch.float32).t().contiguous()}
    return {"qtype": "sym_int4",
            "q": np.ascontiguousarray(np.asarray(q).T),
            "scale": np.ascontiguousarray(np.asarray(s, np.float32).T)}


def quantize_tpu(w, qtype: str = "sym_int4") -> Dict:
    """quantize() + to_tpu_layout() in one step — numpy in, numpy out;
    a tensor is quantized on its own device (:func:`quantize_torch`)."""
    if isinstance(w, torch.Tensor):
        _check_qtype(qtype)
        return to_tpu_layout(quantize_torch(w))
    return to_tpu_layout(quantize(w, qtype))


def dequant_q4(q_t: torch.Tensor, scale_t: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """k-major dequant (the port of ``llama._dequant_q4``): returns
    w (K, N) so that y = x @ w, with w = scale * (q - 8)."""
    half, n = q_t.shape
    lo = (q_t & 0xF).to(torch.int32)
    hi = (q_t >> 4).to(torch.int32)
    q = torch.stack([lo, hi], dim=1).reshape(half * 2, n)
    g = scale_t.shape[0]
    w = ((q - 8).to(torch.float32).reshape(g, QK, n)
         * scale_t.to(torch.float32)[:, None, :])
    return w.reshape(half * 2, n).to(dtype)


def int4_matmul_reference(x: torch.Tensor, q_t: torch.Tensor,
                          scale_t: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain version: :func:`dequant_q4` in f32 followed by an f32
    matmul, cast to ``out_dtype`` (default: x's dtype). The kernel reads
    x in bf16 (the TPU kernel's cast point); given bf16 x the two see the
    same inputs and differ only in f32 summation order."""
    w = dequant_q4(q_t, scale_t, torch.float32)
    y = x.to(torch.float32) @ w
    return y.to(out_dtype if out_dtype is not None else x.dtype)


def int4_matmul(x: torch.Tensor, q_t: torch.Tensor, scale_t: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant_q4_0(q, scale) in the k-major layout.

    x (M, K); q_t (K/2, N) uint8; scale_t (K/32, N) f32; returns (M, N)
    in ``out_dtype`` (bf16 or f32 on the card). A CUDA x launches the
    CUDA kernel (x cast to bf16 first); a CPU x takes the plain
    version."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    half, n = q_t.shape
    if half * 2 != k or k % QK:
        raise ValueError(
            f"q_t {tuple(q_t.shape)} is not the (K/2, N) layout for K={k} "
            f"(K must be a multiple of {QK}); convert ggml (N, K/2) dicts "
            "with to_tpu_layout() first")
    if tuple(scale_t.shape) != (k // QK, n):
        raise ValueError(f"scale_t {tuple(scale_t.shape)} != {(k // QK, n)}")
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q_t, scale_t, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if q_t.device != x.device or scale_t.device != x.device:
        raise ValueError("int4_matmul: x, q_t and scale_t must be on one "
                         "device")
    if q_t.dtype != torch.uint8 or scale_t.dtype != torch.float32:
        raise ValueError("int4_matmul: q_t must be uint8 and scale_t "
                         f"float32, got {q_t.dtype}, {scale_t.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int4_matmul: out_dtype {out_dtype} not bf16/f32")
    if n % 4:
        raise ValueError(f"int4_matmul: N={n} must be a multiple of 4")
    if not (q_t.is_contiguous() and scale_t.is_contiguous()):
        raise ValueError("int4_matmul: q_t and scale_t must be contiguous")
    xb = x.to(torch.bfloat16).contiguous()
    for t in (xb, q_t, scale_t):
        if t.data_ptr() % 16:
            raise ValueError("int4_matmul: tensors must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.bind(
        "int4_matmul", "int4_matmul_bf16out" if out_dtype == torch.bfloat16
        else "int4_matmul_f32out", [_build.P] * 4 + [_build.I] * 3
        + [_build.P])
    rc = fn(xb.data_ptr(), q_t.data_ptr(), scale_t.data_ptr(),
            out.data_ptr(), m, k, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    int4_matmul.launches += 1
    _build.check(rc, "int4_matmul")
    return out


int4_matmul.launches = 0
