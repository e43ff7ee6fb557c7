"""ggml block quantization — the port of ``bigdl_tpu/llm/ggml/quantize.py``,
restricted to the formats that have a kernel in the port.

Formats (unchanged from the JAX package, so the two agree bit for bit;
32-element blocks along the input (K) dim, fp16 scales):

- ``sym_int4``  (q4_0): ``w ≈ scale * (q - 8)``, ``q ∈ [1, 15]``;
- ``asym_int4`` (q4_1): ``w ≈ scale * q + zero``, ``q ∈ [0, 15]``,
  ``zero`` = the block's minimum (fp16);
- ``sym_int8``  (q8_0): ``w ≈ scale * q``, ``q ∈ [-127, 127]`` int8.

Scales are rounded to fp16 BEFORE quantizing, and the rounding of
``w / scale`` is half-to-even (``np.round`` == ``torch.round``). The
4-bit formats pack plane-split nibbles: the low nibble of byte ``i``
holds even k = ``2i``, the high nibble odd k = ``2i + 1`` (not ggml's
usual split into the two halves of a block).

Two implementations of the same arithmetic: :func:`quantize` on numpy
(the host loader and the tests' golden) and :func:`quantize_torch`, which
runs on whatever device its tensor lives on (the card, for weights made
there). The JAX package's native C++ quantizer is bit-compatible and not
ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

QK = 32  # ggml block size


QTYPES = ("sym_int4", "asym_int4", "sym_int8")


def _check_qtype(qtype: str):
    if qtype not in QTYPES:
        raise NotImplementedError(
            f"qtype {qtype!r}: the port implements {', '.join(QTYPES)}; "
            "sym_int5 / nf4 / fp4 / fp8 / bf16 are ROADMAP Queue 1 item 2")


def _to_blocks(w: np.ndarray) -> np.ndarray:
    w = np.ascontiguousarray(w, dtype=np.float32)
    n, k = w.shape
    if k % QK != 0:
        raise ValueError(f"in_features {k} not a multiple of QK={QK}")
    return w.reshape(n, k // QK, QK)


def quantize(w: np.ndarray, qtype: str = "sym_int4") -> Dict[str, np.ndarray]:
    """Quantize an (out, in) weight matrix. Returns ``q`` — uint8 (out,
    in//2) plane-split nibbles for the 4-bit formats, int8 (out, in) for
    ``sym_int8`` — and ``scale`` fp16 (out, in//QK); ``asym_int4`` adds
    ``zero`` fp16 (out, in//QK)."""
    _check_qtype(qtype)
    blocks = _to_blocks(w)
    n = blocks.shape[0]
    if qtype == "asym_int4":
        wmin = blocks.min(axis=2)
        scale = ((blocks.max(axis=2) - wmin) / 15.0).astype(np.float16)
        q = _divide_round(blocks - wmin[..., None], scale).clip(0, 15)
        return {"qtype": qtype,
                "q": _pack_nibbles(q.astype(np.uint8).reshape(n, -1)),
                "scale": scale, "zero": wmin.astype(np.float16)}
    qmax = 127 if qtype == "sym_int8" else 7
    scale = (np.abs(blocks).max(axis=2) / qmax).astype(np.float16)
    q = _divide_round(blocks, scale).clip(-qmax, qmax)
    if qtype == "sym_int8":
        return {"qtype": qtype, "q": q.astype(np.int8).reshape(n, -1),
                "scale": scale}
    q = (q + 8).astype(np.uint8).reshape(n, -1)
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


def dequantize(qdict: Dict[str, np.ndarray]) -> np.ndarray:
    """Inverse of :func:`quantize` (fp32, (out, in))."""
    qtype = qdict["qtype"]
    _check_qtype(qtype)
    scale = np.asarray(qdict["scale"]).astype(np.float32)
    n, nb = scale.shape
    if qtype == "sym_int8":
        q = np.asarray(qdict["q"]).reshape(n, nb, QK).astype(np.float32)
        return (q * scale[..., None]).reshape(n, -1)
    q = _unpack_nibbles(np.asarray(qdict["q"])).reshape(n, nb, QK)
    if qtype == "asym_int4":
        zero = np.asarray(qdict["zero"]).astype(np.float32)
        return (q.astype(np.float32) * scale[..., None]
                + zero[..., None]).reshape(n, -1)
    return ((q.astype(np.float32) - 8.0) * scale[..., None]).reshape(n, -1)


def quantize_torch(w: torch.Tensor, qtype: str = "sym_int4"
                   ) -> Dict[str, torch.Tensor]:
    """:func:`quantize` on a tensor, on the tensor's own device (the
    card, for weights made there). Bit-identical to the numpy version:
    the same f32 arithmetic, fp16 rounding of the scale and half-to-even
    rounding of ``w / scale``."""
    _check_qtype(qtype)
    n, k = w.shape
    if k % QK != 0:
        raise ValueError(f"in_features {k} not a multiple of QK={QK}")
    blocks = w.to(torch.float32).reshape(n, k // QK, QK)
    if qtype == "asym_int4":
        wmin = blocks.amin(dim=2)
        scale = ((blocks.amax(dim=2) - wmin) / 15).to(torch.float16)
        q = _divide_round_torch(blocks - wmin[..., None], scale).clamp(0, 15)
        return {"qtype": qtype, "q": _pack_torch(q.to(torch.uint8), n, k),
                "scale": scale, "zero": wmin.to(torch.float16)}
    qmax = 127 if qtype == "sym_int8" else 7
    scale = (blocks.abs().amax(dim=2) / qmax).to(torch.float16)
    q = _divide_round_torch(blocks, scale).clamp(-qmax, qmax)
    if qtype == "sym_int8":
        return {"qtype": qtype, "q": q.to(torch.int8).reshape(n, k),
                "scale": scale}
    return {"qtype": qtype, "q": _pack_torch((q + 8).to(torch.uint8), n, k),
            "scale": scale}


def _divide_round_torch(blocks: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    s = scale.to(torch.float32)[..., None]
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return torch.where(s > 0, torch.round(blocks / safe),
                       torch.zeros_like(blocks))


def _pack_torch(q: torch.Tensor, n: int, k: int) -> torch.Tensor:
    q = q.reshape(n, k)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).contiguous()
