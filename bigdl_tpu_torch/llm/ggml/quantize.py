"""ggml q4_0 (``sym_int4``) block quantization — the port of
``bigdl_tpu/llm/ggml/quantize.py``, restricted to the format on the
served path.

Layout (unchanged from the JAX package, so the two agree bit for bit):

- 32-element blocks along the input (K) dim; ``w ≈ scale * (q - 8)``,
  ``q ∈ [1, 15]``;
- scales are rounded to fp16 BEFORE quantizing, and the rounding of
  ``w / scale`` is half-to-even (``np.round`` == ``torch.round``);
- plane-split nibble packing: the low nibble of byte ``i`` holds even
  k = ``2i``, the high nibble odd k = ``2i + 1`` (not ggml's usual split
  into the two halves of a block).

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


def _check_qtype(qtype: str):
    if qtype != "sym_int4":
        raise NotImplementedError(
            f"qtype {qtype!r}: the port implements sym_int4 (q4_0) only; "
            "asym_int4 / sym_int8 / nf4 / fp4 are ROADMAP Queue 1 item 2")


def _to_blocks(w: np.ndarray) -> np.ndarray:
    w = np.ascontiguousarray(w, dtype=np.float32)
    n, k = w.shape
    if k % QK != 0:
        raise ValueError(f"in_features {k} not a multiple of QK={QK}")
    return w.reshape(n, k // QK, QK)


def quantize(w: np.ndarray, qtype: str = "sym_int4") -> Dict[str, np.ndarray]:
    """Quantize an (out, in) weight matrix: ``q`` uint8 (out, in//2)
    plane-split nibbles and ``scale`` fp16 (out, in//QK)."""
    _check_qtype(qtype)
    blocks = _to_blocks(w)
    n = blocks.shape[0]
    amax = np.abs(blocks).max(axis=2)
    scale = (amax / 7).astype(np.float16)
    s = scale.astype(np.float32)[..., None]
    q = np.round(np.divide(blocks, s, out=np.zeros_like(blocks),
                           where=s > 0)).clip(-7, 7) + 8
    q = q.astype(np.uint8).reshape(n, -1)
    return {"qtype": qtype, "q": _pack_nibbles(q), "scale": scale}


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
    _check_qtype(qdict["qtype"])
    scale = np.asarray(qdict["scale"]).astype(np.float32)
    n, nb = scale.shape
    q = _unpack_nibbles(np.asarray(qdict["q"])).reshape(n, nb, QK)
    return ((q.astype(np.float32) - 8.0) * scale[..., None]).reshape(n, -1)


def quantize_torch(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """:func:`quantize` on a tensor, on the tensor's own device (the
    card, for weights made there). Bit-identical to the numpy version:
    the same f32 division, fp16 rounding of the scale and half-to-even
    rounding of ``w / scale``."""
    n, k = w.shape
    if k % QK != 0:
        raise ValueError(f"in_features {k} not a multiple of QK={QK}")
    blocks = w.to(torch.float32).reshape(n, k // QK, QK)
    amax = blocks.abs().amax(dim=2)
    scale = (amax / 7).to(torch.float16)
    s = scale.to(torch.float32)[..., None]
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.where(s > 0, torch.round(blocks / safe),
                    torch.zeros_like(blocks)).clamp(-7, 7) + 8
    q = q.to(torch.uint8).reshape(n, k)
    packed = q[:, 0::2] | (q[:, 1::2] << 4)
    return {"qtype": "sym_int4", "q": packed.contiguous(), "scale": scale}
