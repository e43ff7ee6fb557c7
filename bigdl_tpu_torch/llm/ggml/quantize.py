"""ggml block quantization — the port of ``bigdl_tpu/llm/ggml/quantize.py``
(ref: P:llm/ggml/quantize.py + the ggml q4_0/q4_1/q8_0/nf4 C kernels).

Formats (unchanged from the JAX package, so the two agree bit for bit;
32-element blocks along the input (K) dim, fp16 scales):

- ``sym_int4``  (q4_0): ``w ≈ scale * (q - 8)``, ``q ∈ [1, 15]``;
- ``asym_int4`` (q4_1): ``w ≈ scale * q + zero``, ``q ∈ [0, 15]``,
  ``zero`` = the block's minimum (fp16);
- ``sym_int5``: ``w ≈ scale * (q - 16)``, ``q ∈ [1, 31]`` one byte each
  (row-major, unpacked), ``scale = amax / 15``;
- ``sym_int8``  (q8_0): ``w ≈ scale * q``, ``q ∈ [-127, 127]`` int8;
- ``nf4`` / ``fp4``: the index of the nearest entry of a 16-entry
  codebook (:data:`NF4_CODE`, :data:`FP4_CODE`) to ``w / scale``, the
  first on a tie, with ``scale`` = the block's fp16 absmax;
- ``fp8`` / ``bf16``: a plain cast (e4m3fn, bf16), no blocks, no scale.

Scales are rounded to fp16 BEFORE quantizing, and the rounding of
``w / scale`` is half-to-even (``np.round`` == ``torch.round``). The
4-bit formats pack plane-split nibbles: the low nibble of byte ``i``
holds even k = ``2i``, the high nibble odd k = ``2i + 1`` (not ggml's
usual split into the two halves of a block).

Two implementations of the same arithmetic: :func:`quantize` on numpy
(the host loader and the tests' golden; q4_0 and q8_0 through the native
C++ quantizer, :mod:`bigdl_tpu_torch.native`, when it builds, else
:func:`quantize_numpy`, which gives the same bits) and
:func:`quantize_torch`, which runs on whatever device its tensor lives
on (the card, for weights made there). numpy has no bf16 or fp8 dtype,
so :func:`quantize` holds those casts' bits in ``uint16`` / ``uint8``
arrays (:func:`as_tensor` views them back); :func:`quantize_torch`
returns ``torch.bfloat16`` / ``torch.float8_e4m3fn`` tensors. Both
casts round as the JAX package's (``ml_dtypes``) do, which torch's own
cast does not everywhere: an e4m3fn overflow is NaN there, not 448,
and a bf16 NaN keeps its sign and payload.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

QK = 32  # ggml block size

# bitsandbytes/QLoRA NF4 codebook — the reference's nf4 uses the same table
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], dtype=np.float32)

# e2m1 fp4 codebook (sign × {0, .5, 1, 1.5, 2, 3, 4, 6} / 6 absmax-scaled)
FP4_CODE = np.array([
    0.0, 0.0052083334, 0.6666667, 1.0, 0.3333333, 0.5, 0.16666667, 0.25,
    -0.0, -0.0052083334, -0.6666667, -1.0, -0.3333333, -0.5, -0.16666667,
    -0.25], dtype=np.float32)

#: the formats with a dequant-matmul kernel (k-major states); the rest
#: keep the row-major ggml layout and dequantize in plain PyTorch
KERNEL_QTYPES = ("sym_int4", "asym_int4", "sym_int8")
#: the cast formats: no blocks, no scale
CAST_QTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
_BITS = {"bf16": (torch.int16, np.uint16), "fp8": (torch.uint8, np.uint8)}
E4M3_MAX_TIE = 464.0     # halfway from 448 to the NaN code: rounds to 448
CODE_CHUNK = 1 << 24     # codebook distances held at once (64 MB of f32)


def ggml_qtypes() -> Tuple[str, ...]:
    return ("sym_int4", "asym_int4", "sym_int5", "sym_int8", "nf4", "fp4",
            "fp8", "bf16")


def _unknown(qtype: str) -> ValueError:
    return ValueError(f"unknown qtype {qtype!r}; known: {ggml_qtypes()}")


def _code(qtype: str) -> np.ndarray:
    return NF4_CODE if qtype == "nf4" else FP4_CODE


def _to_blocks(w: np.ndarray) -> np.ndarray:
    w = np.ascontiguousarray(w, dtype=np.float32)
    n, k = w.shape
    if k % QK != 0:
        raise ValueError(f"in_features {k} not a multiple of QK={QK}")
    return w.reshape(n, k // QK, QK)


def quantize(w: np.ndarray, qtype: str = "sym_int4") -> Dict[str, np.ndarray]:
    """Quantize an (out, in) weight matrix. Returns a dict of arrays:

    - int4 family and nf4 / fp4: ``q`` uint8 (out, in//2) plane-split
      nibbles; ``scale`` fp16 (out, in//QK); ``asym_int4`` adds ``zero``
    - ``sym_int5``: ``q`` uint8 (out, in), unpacked; ``scale`` fp16
    - ``sym_int8``: ``q`` int8 (out, in); ``scale`` fp16
    - ``fp8`` / ``bf16``: ``q`` (out, in), the cast's bits as uint8 /
      uint16 (no blocks)
    """
    if qtype in ("sym_int4", "sym_int8") and np.ndim(w) == 2 \
            and np.shape(w)[1] % QK == 0:
        from bigdl_tpu_torch.native import (native_quantize_q4_0,
                                            native_quantize_q8_0)
        native = native_quantize_q4_0 if qtype == "sym_int4" \
            else native_quantize_q8_0
        out = native(np.asarray(w, np.float32))
        if out is not None:
            return out
    return quantize_numpy(w, qtype)


def quantize_numpy(w: np.ndarray, qtype: str = "sym_int4"
                   ) -> Dict[str, np.ndarray]:
    """:func:`quantize` without the native quantizer: the same dict from
    numpy alone (what ``quantize`` gives where ``quant.cpp`` does not
    build)."""
    if qtype in CAST_QTYPES:
        q = cast_torch(torch.from_numpy(np.ascontiguousarray(w, np.float32)),
                       qtype)
        return {"qtype": qtype, "q": q.view(_BITS[qtype][0]).numpy()
                .view(_BITS[qtype][1])}
    if qtype not in ggml_qtypes():
        raise _unknown(qtype)
    blocks = _to_blocks(w)
    n = blocks.shape[0]
    if qtype == "asym_int4":
        wmin = blocks.min(axis=2)
        scale = ((blocks.max(axis=2) - wmin) / 15.0).astype(np.float16)
        q = _divide_round(blocks - wmin[..., None], scale).clip(0, 15)
        return {"qtype": qtype,
                "q": _pack_nibbles(q.astype(np.uint8).reshape(n, -1)),
                "scale": scale, "zero": wmin.astype(np.float16)}
    amax = np.abs(blocks).max(axis=2)
    if qtype in ("nf4", "fp4"):
        scale = amax.astype(np.float16)
        idx = np.empty(blocks.shape, np.uint8)
        code = _code(qtype)
        rows = max(1, CODE_CHUNK // (blocks[0].size * code.size))
        for r in range(0, n, rows):
            s = scale[r:r + rows].astype(np.float32)[..., None]
            normed = np.divide(blocks[r:r + rows], s,
                               out=np.zeros_like(blocks[r:r + rows]),
                               where=s > 0)
            idx[r:r + rows] = np.abs(normed[..., None] - code).argmin(-1)
        return {"qtype": qtype, "q": _pack_nibbles(idx.reshape(n, -1)),
                "scale": scale}
    qmax = {"sym_int8": 127, "sym_int5": 15, "sym_int4": 7}[qtype]
    scale = (amax / qmax).astype(np.float16)
    q = _divide_round(blocks, scale).clip(-qmax, qmax)
    if qtype == "sym_int8":
        return {"qtype": qtype, "q": q.astype(np.int8).reshape(n, -1),
                "scale": scale}
    q = (q + qmax + 1).astype(np.uint8).reshape(n, -1)
    if qtype == "sym_int5":
        return {"qtype": qtype, "q": q, "scale": scale}
    return {"qtype": qtype, "q": _pack_nibbles(q), "scale": scale}


def _divide_round(blocks: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """round(blocks / scale) half-to-even, 0 where the fp16 scale is 0."""
    s = scale.astype(np.float32)[..., None]
    return np.round(np.divide(blocks, s, out=np.zeros_like(blocks),
                              where=s > 0))


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(n, k) 4-bit values → (n, k//2) bytes; low nibble = even k-plane,
    high nibble = odd k-plane."""
    return (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8)


def _unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    n, half = packed.shape
    out = np.empty((n, half * 2), dtype=np.uint8)
    out[:, 0::2] = packed & 0xF
    out[:, 1::2] = packed >> 4
    return out


def as_tensor(a, qtype: str = "") -> torch.Tensor:
    """One plane of a quantize dict as a CPU tensor (a tensor stays
    itself): the bf16 / fp8 bits :func:`quantize` holds in uint16 /
    uint8 become a ``torch.bfloat16`` / ``torch.float8_e4m3fn`` tensor of
    those bits; any other array, ``ml_dtypes`` ones from the JAX package
    included, goes through ``tensor_from_numpy``."""
    from bigdl_tpu_torch.llm.convert import tensor_from_numpy
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if qtype in CAST_QTYPES and a.dtype == _BITS[qtype][1]:
        bits = a.view(np.int16) if qtype == "bf16" else a
        return torch.from_numpy(np.array(bits)).view(CAST_QTYPES[qtype])
    return tensor_from_numpy(a, "cpu")


def dequantize(qdict: Dict[str, np.ndarray]) -> np.ndarray:
    """Inverse of :func:`quantize` (fp32, (out, in))."""
    qtype = qdict["qtype"]
    if qtype in CAST_QTYPES:
        return as_tensor(qdict["q"], qtype).to(torch.float32).numpy()
    if qtype not in ggml_qtypes():
        raise _unknown(qtype)
    scale = np.asarray(qdict["scale"]).astype(np.float32)
    n, nb = scale.shape
    if qtype in ("sym_int8", "sym_int5"):
        q = np.asarray(qdict["q"]).reshape(n, nb, QK).astype(np.float32)
        if qtype == "sym_int5":
            q = q - 16.0
        return (q * scale[..., None]).reshape(n, -1)
    q = _unpack_nibbles(np.asarray(qdict["q"])).reshape(n, nb, QK)
    if qtype in ("nf4", "fp4"):
        return (_code(qtype)[q] * scale[..., None]).reshape(n, -1)
    if qtype == "asym_int4":
        zero = np.asarray(qdict["zero"]).astype(np.float32)
        return (q.astype(np.float32) * scale[..., None]
                + zero[..., None]).reshape(n, -1)
    return ((q.astype(np.float32) - 8.0) * scale[..., None]).reshape(n, -1)


def cast_torch(w: torch.Tensor, qtype: str) -> torch.Tensor:
    """``w`` cast to bf16 (``qtype="bf16"``) or e4m3fn (``"fp8"``) on its
    own device, rounded as ``ml_dtypes`` (the JAX package's cast) rounds:
    nearest-even; an e4m3fn overflow past 464 (and ±inf) is NaN with
    the input's sign, where torch's cast saturates to ±448; a bf16 NaN
    keeps sign and payload and sets the quiet bit, where torch's cast
    gives one NaN for all."""
    w = w.to(torch.float32)
    q = w.to(CAST_QTYPES[qtype])
    if qtype == "fp8":
        sign = torch.signbit(w).to(torch.uint8) << 7
        bits = torch.where(w.abs() > E4M3_MAX_TIE, sign | 0x7F,
                           q.view(torch.uint8))
        return bits.view(torch.float8_e4m3fn)
    hi = (w.view(torch.int32) >> 16).to(torch.int16) | 0x40
    return torch.where(torch.isnan(w), hi, q.view(torch.int16)) \
        .view(torch.bfloat16)


def quantize_torch(w: torch.Tensor, qtype: str = "sym_int4"
                   ) -> Dict[str, torch.Tensor]:
    """:func:`quantize` on a tensor, on the tensor's own device (the
    card, for weights made there). Bit-identical to the numpy version:
    the same f32 arithmetic, fp16 rounding of the scale, half-to-even
    rounding of ``w / scale`` and first-index codebook ties
    (``torch.argmin``'s rule, as ``np.argmin``'s). nf4 / fp4 measure the
    codebook distances a slice of rows at a time (a 7B MLP weight's
    whole would be ~2.9 GB)."""
    if qtype in CAST_QTYPES:
        return {"qtype": qtype, "q": cast_torch(w, qtype)}
    if qtype not in ggml_qtypes():
        raise _unknown(qtype)
    n, k = w.shape
    if k % QK != 0:
        raise ValueError(f"in_features {k} not a multiple of QK={QK}")
    blocks = w.to(torch.float32).reshape(n, k // QK, QK)
    if qtype == "asym_int4":
        wmin = blocks.amin(dim=2)
        scale = true_div(blocks.amax(dim=2) - wmin, 15).to(torch.float16)
        q = _divide_round_torch(blocks - wmin[..., None], scale).clamp(0, 15)
        return {"qtype": qtype, "q": _pack_torch(q.to(torch.uint8), n, k),
                "scale": scale, "zero": wmin.to(torch.float16)}
    amax = blocks.abs().amax(dim=2)
    if qtype in ("nf4", "fp4"):
        scale = amax.to(torch.float16)
        code = torch.from_numpy(_code(qtype)).to(w.device)
        idx = torch.empty(blocks.shape, dtype=torch.uint8, device=w.device)
        rows = max(1, CODE_CHUNK // (k * code.numel()))
        for r in range(0, n, rows):
            s = scale[r:r + rows].to(torch.float32)[..., None]
            safe = torch.where(s > 0, s, torch.ones_like(s))
            normed = torch.where(s > 0, blocks[r:r + rows] / safe,
                                 torch.zeros_like(blocks[r:r + rows]))
            idx[r:r + rows] = (normed[..., None] - code).abs() \
                .argmin(dim=-1).to(torch.uint8)
        return {"qtype": qtype, "q": _pack_torch(idx, n, k), "scale": scale}
    qmax = {"sym_int8": 127, "sym_int5": 15, "sym_int4": 7}[qtype]
    scale = true_div(amax, qmax).to(torch.float16)
    q = _divide_round_torch(blocks, scale).clamp(-qmax, qmax)
    if qtype == "sym_int8":
        return {"qtype": qtype, "q": q.to(torch.int8).reshape(n, k),
                "scale": scale}
    q = (q + qmax + 1).to(torch.uint8)
    if qtype == "sym_int5":
        return {"qtype": qtype, "q": q.reshape(n, k), "scale": scale}
    return {"qtype": qtype, "q": _pack_torch(q, n, k), "scale": scale}


def true_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x / d`` correctly rounded on every device. A CUDA tensor divided
    by a Python number is multiplied by the number's f32 reciprocal,
    which is off by an ulp for some ``x`` (and then, past the fp16
    rounding, off the numpy scale); a 0-d tensor on ``x``'s device takes
    the true division."""
    return x / torch.tensor(float(d), dtype=x.dtype, device=x.device)


def _divide_round_torch(blocks: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    s = scale.to(torch.float32)[..., None]
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return torch.where(s > 0, torch.round(blocks / safe),
                       torch.zeros_like(blocks))


def _pack_torch(q: torch.Tensor, n: int, k: int) -> torch.Tensor:
    q = q.reshape(n, k)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).contiguous()
