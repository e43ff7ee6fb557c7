"""Build and load the native quantizer with ``g++`` and ``ctypes`` — the
port of ``bigdl_tpu/native/build.py`` (the C API + ctypes is the binding
layer, like the reference's ctypes-into-libllama path, SURVEY.md §2.8).

The build runs at first use, never at import, into
``bigdl_tpu_torch/_build/`` (listed in ``.gitignore``; never beside the
source), under a name keyed by a hash of the source, the flags and the
host's CPU (``-march=native`` code may not run on another CPU), so an
edited source or a copy on another machine rebuilds. It compiles to a
temporary name and renames it into place, so processes building at once
do not load a half-written library. A failed build logs one warning
and leaves every caller on its numpy path, which gives the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
import time
from typing import Optional

logger = logging.getLogger("bigdl_tpu_torch.native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quant.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
FLAGS = (("-fopenmp",), ())      # OpenMP when the compiler has it
#: seconds the successful build took (0.0 when the library was cached)
build_seconds: Optional[float] = None


def host_cpu() -> str:
    """The host CPU's model and feature flags, as ``/proc/cpuinfo`` gives
    them for its first core (the machine's name where it cannot be
    read)."""
    keep = ("model name", "flags", "features", "cpu part", "cpu implementer")
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break
                if ln.split(":", 1)[0].strip().lower() in keep:
                    lines.append(ln.strip())
    except OSError:
        pass
    return "\n".join(lines) or platform.machine()


def lib_path(flags=FLAGS[0]) -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(host_cpu().encode())
    return os.path.join(BUILD_DIR, f"libquant-{h.hexdigest()[:16]}.so")


def _build() -> Optional[str]:
    global build_seconds
    errors = []
    for flags in FLAGS:
        out = lib_path(flags)
        if os.path.exists(out):
            build_seconds = 0.0
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", *flags,
               _SRC, "-o", tmp]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(str(e))
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
            logger.info("built %s (%s)", out,
                        "openmp" if flags else "single-thread")
            return out
        errors.append(r.stderr.decode(errors="replace")[-400:])
    logger.warning("native quantizer did not build (%s); quantize() keeps "
                   "its numpy path", " | ".join(errors))
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building on first call; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.quantize_q4_0.argtypes = [f32p, i64, i64, u8p, u16p]
        lib.dequantize_q4_0.argtypes = [u8p, u16p, i64, i64, f32p]
        lib.quantize_q8_0.argtypes = [f32p, i64, i64, i8p, u16p]
        lib.dequantize_q8_0.argtypes = [i8p, u16p, i64, i64, f32p]
        lib.matmul_q4_0.argtypes = [f32p, u8p, u16p, i64, i64, i64, f32p]
        for fn in ("quantize_q4_0", "dequantize_q4_0", "quantize_q8_0",
                   "dequantize_q8_0", "matmul_q4_0"):
            getattr(lib, fn).restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None
