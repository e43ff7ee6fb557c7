"""numpy-facing wrappers over the native quant library — the port of
``bigdl_tpu/native/quantize.py``: the same functions and signatures.
Each returns None when the library is unavailable."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from bigdl_tpu_torch.native.build import get_lib

QK = 32


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_quantize_q4_0(w: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(w, np.float32)
    n, k = w.shape
    if k % QK:
        return None
    q = np.empty((n, k // 2), np.uint8)
    scale = np.empty((n, k // QK), np.uint16)
    lib.quantize_q4_0(_ptr(w, ctypes.c_float), n, k,
                      _ptr(q, ctypes.c_uint8), _ptr(scale, ctypes.c_uint16))
    return {"qtype": "sym_int4", "q": q, "scale": scale.view(np.float16)}


def native_dequantize_q4_0(q: np.ndarray,
                           scale: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.uint8)
    sc = np.ascontiguousarray(scale, np.float16).view(np.uint16)
    n = q.shape[0]
    k = q.shape[1] * 2
    w = np.empty((n, k), np.float32)
    lib.dequantize_q4_0(_ptr(q, ctypes.c_uint8), _ptr(sc, ctypes.c_uint16),
                        n, k, _ptr(w, ctypes.c_float))
    return w


def native_quantize_q8_0(w: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(w, np.float32)
    n, k = w.shape
    if k % QK:
        return None
    q = np.empty((n, k), np.int8)
    scale = np.empty((n, k // QK), np.uint16)
    lib.quantize_q8_0(_ptr(w, ctypes.c_float), n, k,
                      _ptr(q, ctypes.c_int8), _ptr(scale, ctypes.c_uint16))
    return {"qtype": "sym_int8", "q": q, "scale": scale.view(np.float16)}


def native_matmul_q4_0(x: np.ndarray, q: np.ndarray,
                       scale: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    q = np.ascontiguousarray(q, np.uint8)
    sc = np.ascontiguousarray(scale, np.float16).view(np.uint16)
    m, k = x.shape
    n = q.shape[0]
    y = np.empty((m, n), np.float32)
    lib.matmul_q4_0(_ptr(x, ctypes.c_float), _ptr(q, ctypes.c_uint8),
                    _ptr(sc, ctypes.c_uint16), m, k, n,
                    _ptr(y, ctypes.c_float))
    return y
